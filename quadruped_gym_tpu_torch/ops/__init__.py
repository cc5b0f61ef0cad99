"""Batch-minor physics: the lane layout, the leg engine and the kernels.

Counterpart of ``quadruped_gym_tpu/ops``. ``leg_engine`` is the plain
PyTorch leg-batched engine; ``cuda_engine`` launches the hand-written
kernels (``csrc/``) that replace the JAX package's Pallas kernels. Of
``lane_engine`` the state and its conversions are ported; its ``step``
and ``control_step`` are not yet (ROADMAP.md A.10).
"""

from . import lane, lane_engine, leg_engine  # noqa: F401
from .lane_engine import (  # noqa: F401
    LaneState,
    from_batched,
    make_lane_state,
    to_batched,
)
