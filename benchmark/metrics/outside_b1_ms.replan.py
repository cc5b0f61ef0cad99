"""``outside_b1_ms.replan``: the median, over the traced replans, of the
replan's host span (the call of ``plan_and_act`` to its control on the
host) less the device time of its one B1 call: what the runtime, MPPI's
sampling and update, the rollout dispatch, the kernel wrapper and the
read-back add to the kernel. The i-th B1 event of the trace is the i-th
replan's (one launch a solve, one solve a request); None where the counts
differ."""

import numpy as np


def read(ctx):
    if ctx.trace is None:
        return None
    b1 = sorted(ctx.trace.kernels("fused_rollout_kernel"),
                key=lambda e: e.start_us)
    if not b1 or len(b1) != len(ctx.requests):
        return None
    return float(np.median([1e3 * (r.end - r.start) - 1e-3 * (e.end_us - e.start_us)
                            for r, e in zip(ctx.requests, b1)]))
