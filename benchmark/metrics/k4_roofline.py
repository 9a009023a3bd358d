"""k4_roofline: kernel K4 (``block_combine``, the dense algebra's block
combinations) against its bound, in %.

A launch reads every input block and the addend once and writes its
outputs once: the program counts those bytes from the launch's shapes
(``k4.bytes``, 8 L D (rows + q outputs) bytes; 3.32 GB for the
Rayleigh-Ritz update at m=16, N=120).  Its operations, 8 rows q D, take at
most half the bytes' time at the float32 peak in every call of the
solvers, so the bound is the bytes over the memory rate.  The share is the
window's bytes over the memory rate, over K4's device time by kernel name.
A program without K4 counts no bytes and gives nothing."""

from benchmark import peaks

KERNELS = ("block_combine_kernel",)


def read(run):
    from benchmark import spans, trace
    got = spans.counts(run)
    nbytes = got.get("k4.bytes", 0) if got else 0
    if not nbytes:
        return None
    t = trace.device_s(run.trace, KERNELS).get("total")
    if not t:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_S / t
