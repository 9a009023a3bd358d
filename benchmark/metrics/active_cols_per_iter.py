"""active_cols_per_iter: the eigensolver's active (unlocked) columns, the
ones that get a search direction, summed over the iterations of the traced
window (the program's counter ``lobpcg.active_cols``), per LOBPCG
iteration.  A program without that counter gives nothing."""


def read(run):
    from benchmark import spans
    got = spans.counts(run)
    n = got.get("lobpcg.active_cols", 0) if got else 0
    return n / run.iterations if n else None
