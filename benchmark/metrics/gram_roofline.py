"""gram_roofline: kernel K6 (``gram_chunks``, the dense algebra's chunked
Grams) against its bytes bound, in %.

A launch reads every block once (the right side not at all where it is the
left: a self-Gram) and writes and reads its complex128 partials once: the
program counts those bytes from the launch's shapes (``gram.bytes``, 8 L D
(P + Q) + 32 L groups P Q; 0.68 GB for a 16 x 16 Gram at m=16, N=120, 3.98
GB for the Rayleigh-Ritz Gram of six blocks).  The share is the window's
bytes over the memory rate, over K6's device time by kernel name (its two
passes).  The 16-row Grams are bound by their bytes; the 48 x 48
Rayleigh-Ritz Gram by its operations (95.5 GFLOP, 1.43 ms at the float32
peak against 1.19 ms of bytes), so the share reads below what the kernel
reaches of its own bound.  A program without K6 counts no bytes and gives
nothing."""

from benchmark import peaks

KERNELS = ("gram_chunks_kernel", "gram_fold_kernel")


def read(run):
    from benchmark import spans, trace
    got = spans.counts(run)
    nbytes = got.get("gram.bytes", 0) if got else 0
    if not nbytes:
        return None
    t = trace.device_s(run.trace, KERNELS).get("total")
    if not t:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_S / t
