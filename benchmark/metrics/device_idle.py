"""device_idle: the share of the traced window in which no operation ran on
the device, 1 - (union of device intervals / window), in %."""


def read(run):
    from benchmark import trace
    if run.trace is None:
        return None
    w, busy = trace.window_s(run.trace), trace.busy_s(run.trace)
    return 100.0 * (1.0 - busy / w) if w > 0 and busy > 0 else None
