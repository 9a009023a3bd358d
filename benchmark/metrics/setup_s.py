"""setup_s: from the start of the process to the start of the window:
imports, the kernel library (built on a checkout's first run), the masks,
the solver, the entry block or warm-up solve, the refines' warm-up."""


def read(run):
    return run.setup_s
