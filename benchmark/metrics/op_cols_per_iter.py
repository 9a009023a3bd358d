"""op_cols_per_iter: columns the operator was applied to (the program's
counter ``op.columns``, lanes times columns of every apply, the refines'
included) per LOBPCG iteration of the traced window: the operator's work,
whatever implements the DFT."""


def read(run):
    from benchmark import spans
    got = spans.counts(run)
    n = got.get("op.columns", 0) if got else 0
    return n / run.iterations if n else None
