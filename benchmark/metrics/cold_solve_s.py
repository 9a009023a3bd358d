"""cold_solve_s: the window's wall (host clock, the card synchronised at
both ends) over the cold solves attempted in it, refines and escalations
included."""


def read(run):
    return run.window_s / len(run.points) if run.points else None
