"""``nccl_ms``: the device time (ms) of the collectives' kernels (those
whose name holds ``nccl``) a solve on the traced card, rank 0's, as the
median over the traced solves. A solve's share is what runs from the
start of its fused rollout kernel (B1) to the start of the next one: the
MIN, SUM and SUM all-reduces of its update and the broadcast of the next
request's index. The MIN all-reduce's kernel starts when this card's B1
ends and ends after the slowest rank's: the number is rank 0's wait for
the other ranks plus the transfers, the cost that exists only across
cards. None where the trace saw no such kernel or fewer than two B1
launches: a group of one rank runs no collective kernel, so it cannot
pass for four."""

import bisect
import statistics


def read(ctx):
    if ctx.trace is None:
        return None
    b1 = sorted(ev.start_us for ev in ctx.trace.kernels("fused_rollout_kernel"))
    nccl = [ev for ev in ctx.trace.events if "nccl" in ev.name.lower()]
    if len(b1) < 2 or not nccl:
        return None
    per_solve = [0.0] * (len(b1) - 1)
    for ev in nccl:
        i = bisect.bisect_right(b1, ev.start_us) - 1
        if 0 <= i < len(per_solve):
            per_solve[i] += ev.end_us - ev.start_us
    return 1e-3 * statistics.median(per_solve)
