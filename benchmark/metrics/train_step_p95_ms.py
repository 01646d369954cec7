"""The 95th percentile, over every step of the traced window, of the
device time between successive step boundaries: a CUDA event recorded on
the step's stream at each labeled ``next()``, the last step ending at an
event after the epoch's drain. A stall on the host or on the card
lengthens it. Read in the ``--trace 1`` run, whose profiler lengthens a
host-bound step (PERF.md gives by how much)."""

import numpy as np


def read(ctx):
    if ctx.intervals_ms is None or not len(ctx.intervals_ms):
        return None
    return float(np.percentile(ctx.intervals_ms, 95))
