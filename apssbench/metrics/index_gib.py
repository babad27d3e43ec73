"""The index's bytes, ``serving.index.index_nbytes``, in GiB."""


def read(run):
    nbytes = run.counters.get("index_bytes")
    return None if nbytes is None else nbytes / float(1 << 30)
