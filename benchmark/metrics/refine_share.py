"""refine_share: host time of the refines (the program's span
``pcx.refine``: the light refine of every point and the complex128 refine
of an escalation) over the traced window's wall, in %.  A refine ends in
its read-back to the host, so its host time is its time."""


def read(run):
    from benchmark import spans
    tot = spans.totals(run)
    ms = sum(rec[1] for path, rec in tot.items()
             if path.split(spans.SEP)[-1] == "pcx.refine") if tot else 0.0
    return 100.0 * ms / (1e3 * run.window_s) if ms else None
