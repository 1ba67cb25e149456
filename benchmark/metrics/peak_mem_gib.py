"""Device memory allocated at its peak over the window, in GiB:
``torch.cuda.max_memory_allocated()`` read at the window's close, its
peak reset at the end of set-up."""


def read(run):
    if not run.peak_bytes:
        return None
    return run.peak_bytes / 2 ** 30
