"""dense_ms_per_iter: device time of the LOBPCG loop's dense algebra, the
SVQB orthonormalizations and the Rayleigh-Ritz step with its Gram, small
eigenproblem and mixes (the program's spans ``pcx.svqb`` and ``pcx.rr``
under ``pcx.lobpcg``, their ``pcx.eigh`` included), per iteration of the
traced window, in ms."""


def read(run):
    from benchmark import spans
    tot = spans.totals(run)
    ms = spans.loop_ms(tot, ("pcx.svqb", "pcx.rr")) if tot else 0.0
    return ms / run.iterations if ms else None
