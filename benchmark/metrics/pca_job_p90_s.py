"""pca_job_p90_s: the 90th percentile (numpy's linear interpolation) of
the wall seconds of every job of the window."""

import numpy as np


def read(win):
    walls = [r["wall_s"] for r in win.records]
    return float(np.percentile(walls, 90)) if walls else None
