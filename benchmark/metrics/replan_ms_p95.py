"""``replan_ms_p95``: the 95th percentile, over every replan of the window,
of the time from the call of ``plan_and_act`` to its control on the host
(numpy's linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    return float(np.percentile([1e3 * (r.end - r.start) for r in ctx.requests],
                               95))
