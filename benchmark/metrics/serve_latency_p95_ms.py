"""The 95th percentile of every request's latency in the window, from the
call of the entry to the synchronise after it returns, in ms."""

import numpy as np


def read(run):
    if not run.window.latency_s:
        return None
    return float(np.percentile(run.window.latency_s, 95)) * 1e3
