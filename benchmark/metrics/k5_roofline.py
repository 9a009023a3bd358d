"""k5_roofline: kernel K5 (``op_blocks``, the operator's curl and penalty
block multiplies on either side of K2) against its bound, in %.

A launch reads each block and symbol once and writes its output once: the
program counts those bytes from the launch's shapes (``k5.bytes``; with
V = 24 N^3 bytes, a column or a complex symbol, (2c + 1) V for the pass
before the forward DFT at c columns, (3c + 2.5) V for the one after the
inverse DFT with the penalty; 1.37 and 2.09 GB at m=16, N=120).  Its
operations, about ten a complex value, take a small fraction of the bytes'
time at the float32 peak, so the bound is the bytes over the memory rate.
The share is the window's bytes over the memory rate, over K5's device
time by kernel name.  A program without K5 counts no bytes and gives
nothing."""

from benchmark import peaks

KERNELS = ("op_blocks_kernel",)


def read(run):
    from benchmark import spans, trace
    got = spans.counts(run)
    nbytes = got.get("k5.bytes", 0) if got else 0
    if not nbytes:
        return None
    t = trace.device_s(run.trace, KERNELS).get("total")
    if not t:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_S / t
