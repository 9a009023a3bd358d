"""k1_roofline: kernel K1 (``resid_precond``) against its bound, in %.

A call on m columns of 3 N^3 complex64 reads x, H x, the preconditioner's
real diagonal and complex off-diagonal (3 N^3 each) and the m Ritz values,
and writes w and the m residual sums: 72 m N^3 + 36 N^3 + 8 m bytes (2.05
GB at m=16, N=120), and does 78 m N^3 float32 operations; the bound is the
larger of bytes over the memory rate and operations over the float32
peak.  The share is that bound over the window's launches (the program's
counter; every call takes the block's m columns) over K1's device time by
kernel name."""

from benchmark import peaks

KERNELS = ("resid_precond_kernel", "column_sum_kernel")


def call_bytes(m: int, n: int) -> float:
    return 72.0 * m * n ** 3 + 36.0 * n ** 3 + 8.0 * m


def call_flops(m: int, n: int) -> float:
    return 78.0 * m * n ** 3


def read(run):
    from benchmark import trace
    calls = run.launches.get("resid_precond", 0)
    if run.trace is None or not calls:
        return None
    t = trace.device_s(run.trace, KERNELS).get("total")
    if not t:
        return None
    m, n = run.block_width, run.n
    bound = max(call_bytes(m, n) / peaks.HBM_BYTES_S,
                call_flops(m, n) / peaks.F32_FLOPS)
    return 100.0 * calls * bound / t
