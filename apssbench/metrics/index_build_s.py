"""Host-clock seconds of ``build_index`` over the whole corpus, ended by a
``synchronize()``."""


def read(run):
    return run.counters.get("index_build_s")
