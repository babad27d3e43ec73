"""``torch.cuda.max_memory_allocated()`` in GiB, reset just before the
port's set-up call (the index build or the first join) and read at the
window's end: the benchmark's inputs that are alive then count too."""


def read(run):
    return run.peak_bytes / float(1 << 30) if run.peak_bytes else None
