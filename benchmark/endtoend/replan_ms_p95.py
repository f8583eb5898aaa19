"""The 95th percentile of every call's latency in the window, in ms: the
call until its costs are on the host (host clock)."""

import numpy as np


def read(ctx):
    return 1e3 * float(np.percentile(ctx["walls"], 95))
