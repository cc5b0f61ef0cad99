"""``b2_roofline_pct.env``: the substep kernel's (B2,
``ops/csrc/substep_kernel.cu``) share of its roofline over its calls in
the trace: per call the larger of the frozen operations (environments x
(frame_skip x the configuration's operations a substep + its sensors'))
over the FP32 peak and the true bytes over the HBM peak, over the calls'
device time. None where the trace saw no call."""

from benchmark.harness import kernel_roofline


def read(ctx):
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    n = tr["num_envs"]
    ops = n * (tr["env"]["frame_skip"] * cfg["ops_per_substep"] + cfg["ops_sensors"])
    return kernel_roofline(ctx, "substep_kernel", ops, n * cfg["b2_bytes_per_lane"])
