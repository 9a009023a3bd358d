"""k2_blocks_per_sm: the blocks of kernel K2 (``axis_dft``) resident on
each SM, averaged over the window's launches: the program's counter
``k2.sm_blocks`` (each launch adds the blocks per SM its launch computed
from its shared memory) over K2's launches by batch.  At N = 100 to 144 two
blocks fit an SM, at N=150 one.  A program without that counter gives
nothing."""


def read(run):
    from benchmark import spans
    got = spans.counts(run)
    blocks = got.get("k2.sm_blocks", 0) if got else 0
    launches = sum(run.k2_by_batch.values())
    return blocks / launches if blocks and launches else None
