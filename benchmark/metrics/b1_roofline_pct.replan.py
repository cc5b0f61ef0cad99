"""``b1_roofline_pct``: the fused rollout kernel's (B1,
``ops/csrc/rollout_kernel.cu``) share of its roofline: per call the larger
of the frozen operations over the FP32 peak and the true bytes over the
HBM peak, times the calls the trace saw, over their device time. None
where the trace saw no call."""

from benchmark.harness import b1_roofline_pct as read  # noqa: F401
