"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
in GiB: what sets the largest D that fits on the card."""


def read(run):
    return run.peak_mem_bytes / 2 ** 30 if run.peak_mem_bytes else None
