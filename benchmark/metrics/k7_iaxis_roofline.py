"""k7_iaxis_roofline: kernel K7 (``crossdof_kernel``) in its instances
with an i-axis pair against their bound, in %.

The pairs 13 and 23 end in a transposed average along i, the grid's
fastest axis: the instances that hold them read neighbourhoods that pair
12 alone does not.  Each K7 launch adds the bytes it must read and write
to ``k7.bytes``, and the launches whose nonzero pairs include 13 or 23 add
the same bytes to ``k7.iaxis_bytes`` ((48 c + 4 (3 + masks)) N^3 at c
columns; 1.362 GB at m=16, N=120 with pair 13 alone).  The share is those
bytes over the memory rate, over K7's device time by kernel name; it is
read only where every K7 launch of the window had an i-axis pair (the two
counters agree), so that the time is the i-axis instances' alone.  A
program without the counter, or a window with pair 12 alone or with both
kinds of launch, gives nothing."""

from benchmark import peaks

KERNELS = ("crossdof_kernel",)


def read(run):
    from benchmark import spans, trace
    got = spans.counts(run)
    nbytes = got.get("k7.iaxis_bytes", 0) if got else 0
    if not nbytes or nbytes != got.get("k7.bytes"):
        return None
    t = trace.device_s(run.trace, KERNELS).get("total")
    if not t:
        return None
    return 100.0 * nbytes / peaks.HBM_BYTES_S / t
