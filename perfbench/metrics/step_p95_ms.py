"""95th percentile of the interval between successive frames the GUI
redrew, over every step of the window (host clock), in ms."""

import numpy as np


def read(run):
    if not run.steps:
        return None
    return float(np.percentile([s["interval_s"] for s in run.steps], 95)) * 1e3
