"""peak_mem_gib.ensemble: the most device memory allocated in the window
(`torch.cuda.max_memory_allocated` after a reset at its start), GiB.  It
is what caps the lanes of one call."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2 ** 30
