"""eltwise_ms_per_iter: device time of PyTorch's eager elementwise kernels
(``trace.FAMILIES``) per LOBPCG iteration of the traced window, in ms."""

FAMILY = "eager elementwise"


def read(run):
    from benchmark import trace
    if run.trace is None or not run.iterations:
        return None
    s = trace.device_s(run.trace).get(FAMILY)
    return 1e3 * s / run.iterations if s else None
