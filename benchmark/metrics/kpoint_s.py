"""kpoint_s: the window's wall (host clock, the card synchronised at both
ends) over the k-points attempted in it, escalations, cold retries and
refines included."""


def read(run):
    return run.window_s / len(run.points) if run.points else None
