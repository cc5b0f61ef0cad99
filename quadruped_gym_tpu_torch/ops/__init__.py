"""Batch-minor physics: the lane layout, the lane and leg engines and the
kernels.

Counterpart of ``quadruped_gym_tpu/ops``. ``lane_engine`` is the plain
PyTorch engine for every model (its ``step`` and ``control_step`` are the
package's); ``leg_engine`` folds the four identical legs into a (4, B)
lane dim and takes every model whose legs are identical chains on a free
base with collision geoms on the legs and the base
(``leg_engine.is_compatible``: the robot's ``full`` model included);
``cuda_engine`` launches the hand-written kernels (``csrc/``) that
replace the JAX package's Pallas kernels, on the models the leg engine
takes.
"""

from . import lane, lane_engine, leg_engine  # noqa: F401
from .lane_engine import (  # noqa: F401
    LaneState,
    control_step,
    from_batched,
    make_lane_state,
    step,
    to_batched,
)
