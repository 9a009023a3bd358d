"""k7_roofline: kernel K7 (``crossdof_kernel``, the cross-DoF eps^{-1} in
one pass) against its bound, in %.

An apply must read x and write y once, and read the diagonal and the edge
masks the nonzero pairs need once: the program counts those bytes from the
launch's shapes (``k7.bytes``; (48 c + 4 (3 + masks)) N^3 at c columns,
1.362 GB at m=16, N=120 with pair 12 alone), not what the kernel reads
again from its caches.  Its operations, about sixty a grid point and
column, take a small fraction of the bytes' time at the float32 peak, so
the bound is the bytes over the memory rate.  The share is the window's
bytes over the memory rate, over K7's device time by kernel name.  A
program without K7, or a window with no cross-DoF apply, counts no bytes
and gives nothing."""

from benchmark import peaks

KERNELS = ("crossdof_kernel",)


def read(run):
    from benchmark import spans, trace
    got = spans.counts(run)
    nbytes = got.get("k7.bytes", 0) if got else 0
    if not nbytes:
        return None
    t = trace.device_s(run.trace, KERNELS).get("total")
    if not t:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_S / t
