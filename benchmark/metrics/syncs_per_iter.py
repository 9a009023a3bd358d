"""syncs_per_iter: the program's host syncs (its ``sync.*`` counters: the
loop's read-back and uploads, each ``eigh``'s error flag, the doom check,
the result and the refines' read-backs, the symbols' upload) per LOBPCG
iteration of the traced window."""


def read(run):
    from benchmark import spans
    got = spans.counts(run)
    n = sum(v for k, v in got.items() if k.startswith("sync.")) if got \
        else 0
    return n / run.iterations if n else None
