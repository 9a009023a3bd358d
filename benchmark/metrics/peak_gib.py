"""peak_gib: ``torch.cuda.max_memory_allocated()`` over the window (reset
when set-up ends), in GiB; nothing on the CPU."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
