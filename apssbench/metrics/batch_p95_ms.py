"""The 95th percentile, over every batch of the window, of the host-clock
time from the call to the moment its ``Matches`` are on the host."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.step_s) * 1e3, 95)) if run.step_s else None
