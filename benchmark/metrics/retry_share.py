"""retry_share: k-points whose solve the gate sent to the complex128
escalation or to the cold retry, over the k-points attempted, in %."""


def read(run):
    if not run.points:
        return None
    redo = sum(p.escalated or p.retried for p in run.points)
    return 100.0 * redo / len(run.points)
