"""iters_per_solve: LOBPCG iterations (``EigenResult.iterations``) over the
cold solves attempted."""


def read(run):
    return run.iterations / len(run.points) if run.points else None
