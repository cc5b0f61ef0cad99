"""``mfu_pct``: the whole step's share (%) of the card's FP32 peak: the
frozen operations of the rollouts of every solve completed in the traced
window (S x H x the configuration's operations a rollout step; MPPI's
noise, clamp and update, under 1e-4 of them, are not counted) over the
window's time times the peak."""

from benchmark.harness import mfu_pct


def read(ctx):
    tr = ctx.cell.traffic
    return mfu_pct(ctx, tr["num_samples"] * tr["horizon"]
                   * ctx.cell.config["ops_per_rollout_step"])
