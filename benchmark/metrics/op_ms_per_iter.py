"""op_ms_per_iter: device time of the operator applies inside the LOBPCG
loop (the program's span ``pcx.op`` under ``pcx.lobpcg``: K2, the
dielectric, the curl and penalty symbols), per iteration of the traced
window, in ms."""


def read(run):
    from benchmark import spans
    tot = spans.totals(run)
    ms = spans.loop_ms(tot, ("pcx.op",)) if tot else 0.0
    return ms / run.iterations if ms else None
