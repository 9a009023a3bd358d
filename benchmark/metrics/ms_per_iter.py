"""ms_per_iter: the traced window's wall over its LOBPCG iterations (cold
retries included), in ms."""


def read(run):
    return 1e3 * run.window_s / run.iterations if run.iterations else None
