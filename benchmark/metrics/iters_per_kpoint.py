"""iters_per_kpoint: LOBPCG iterations (``EigenResult.iterations``, cold
retries included) over the k-points attempted."""


def read(run):
    return run.iterations / len(run.points) if run.points else None
