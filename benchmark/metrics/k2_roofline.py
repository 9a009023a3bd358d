"""k2_roofline: kernel K2 (``axis_dft``) against its bound, in %.

A pass over B columns of N^3 complex64 reads each input byte once and
writes each output byte once: 16 B N^3 bytes (1.327 GB at B=48, N=120).
Its operations (a mixed-radix FFT, 3.95 GFLOP at B=48, N=120) take a
seventh of the bytes' time at the float32 peak, so the bound is the bytes
over the memory rate.  The share is that bound, summed over the window's
launches by batch (the program's counter), over K2's device time by
kernel name."""

from benchmark import peaks

KERNELS = ("axis_dft_kernel",)


def pass_bytes(b: int, n: int) -> float:
    return 16.0 * b * n ** 3


def read(run):
    from benchmark import trace
    if run.trace is None or not run.k2_by_batch:
        return None
    t = trace.device_s(run.trace, KERNELS).get("total")
    if not t:
        return None
    need = sum(k * pass_bytes(b, run.n) for b, k in run.k2_by_batch.items())
    return 100.0 * need / peaks.HBM_BYTES_S / t
