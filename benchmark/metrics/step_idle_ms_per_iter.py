"""step_idle_ms_per_iter: device idle time while the host runs the LOBPCG
loop's per-iteration bookkeeping, per iteration of the traced window, in
ms: the idle gaps of at least ``trace.MIN_GAP_NS`` between the device's
busy intervals whose midpoint lies in a host event of the program's span
``pcx.step`` (spans and kernels share the profiler's clock).  Nothing
without device events."""

import bisect

STEP = "pcx.step"


def read(run):
    from benchmark import trace
    if run.trace is None or not run.trace.device or not run.iterations:
        return None
    steps = sorted((s, t) for name, s, t in run.trace.host if name == STEP)
    if not steps:
        return None
    starts = [s for s, _ in steps]
    idle = 0
    for s, t in trace.gaps(run.trace):
        mid = (s + t) // 2
        i = bisect.bisect_right(starts, mid) - 1
        if t - s >= trace.MIN_GAP_NS and i >= 0 and mid <= steps[i][1]:
            idle += t - s
    return 1e-6 * idle / run.iterations
