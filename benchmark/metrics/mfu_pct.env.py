"""``mfu_pct.env``: the whole step's share (%) of the card's FP32 peak: the
frozen operations of every env step completed in the traced window (per
environment the physics of a control step, frame_skip substeps and the
sensors, plus the actor's mean; the task layer and the reset, a few
thousand operations, are not counted) over the window's time times the
peak."""

from benchmark.harness import mfu_pct


def read(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    per_env = (tr["env"]["frame_skip"] * cfg["ops_per_substep"]
               + cfg["ops_sensors"] + tr["actor_ops_per_env"])
    return mfu_pct(ctx, tr["num_envs"] * per_env)
