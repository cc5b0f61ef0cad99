"""Batch-minor physics: the lane layout, the lane and leg engines and the
kernels.

Counterpart of ``quadruped_gym_tpu/ops``. ``lane_engine`` is the plain
PyTorch engine for every model (its ``step`` and ``control_step`` are the
package's); ``leg_engine`` folds the four identical legs into a (4, B)
lane dim and needs the feet-only collision model
(``leg_engine.is_compatible``); ``cuda_engine`` launches the hand-written
kernels (``csrc/``) that replace the JAX package's Pallas kernels.
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
