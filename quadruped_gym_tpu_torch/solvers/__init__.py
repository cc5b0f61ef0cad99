"""Sampling MPC solvers: MPPI and CEM over batched rollouts.

Counterpart of ``quadruped_gym_tpu/solvers``; the gradient solvers
(iLQR, SQP) are not ported yet (ROADMAP.md A.13). The receding-horizon
runtime is ``runtime.mpc_runtime``.
"""

from . import cem, mppi, rollout  # noqa: F401
from .cem import CEMConfig  # noqa: F401
from .mppi import MPPIConfig, PlanResult  # noqa: F401
from .rollout import RolloutConfig, make_cost_fn  # noqa: F401
