"""diel_ms_per_iter: device time of the dielectric apply inside the
operator applies of the LOBPCG loop (the program's span ``pcx.diel`` in
``pcx.op`` under ``pcx.lobpcg``), per iteration of the traced window, in
ms."""


def read(run):
    from benchmark import spans
    tot = spans.totals(run)
    ms = spans.loop_ms(tot, ("pcx.diel",)) if tot else 0.0
    return ms / run.iterations if ms else None
