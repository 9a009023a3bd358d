"""k3_roofline: kernel K3 (``gram9``, the Rayleigh-Ritz Gram of the
``rr_gram="pallas"`` route) against its bound, in %.

A launch reads the six (m, D) complex64 blocks [X|W|P] and [HX|HW|HP]
once and writes and reads its complex64 partials, one (3m, 3m) a chunk of
D, once: the program counts those bytes from the launch's shapes
(``k3.bytes``, 8 L (6 m D + 2 chunks (3m)^2); 3.98 GB of blocks and 0.09
GB of partials at m=16, N=120).  K3 runs its 48 x 48 Gram on the tensor
cores in 3xTF32 (3 x 95.6 GFLOP at 495 TFLOP/s, 0.58 ms), so its bytes
bound it (1.22 ms at 3.35 TB/s).  The share is the window's bytes over the
memory rate, over K3's device time by kernel name (its two kernels).  A
program without the counter, or a window of the ``"xla"`` route, gives
nothing."""

from benchmark import peaks

KERNELS = ("gram9_partial_kernel", "gram9_reduce_kernel")


def read(run):
    from benchmark import spans, trace
    got = spans.counts(run)
    nbytes = got.get("k3.bytes", 0) if got else 0
    if not nbytes:
        return None
    t = trace.device_s(run.trace, KERNELS).get("total")
    if not t:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_S / t
