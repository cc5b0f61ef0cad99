"""Trajectory-optimization solvers: sampling MPC (MPPI, CEM) and the
gradient solvers (iLQR, SQP).

Counterpart of ``quadruped_gym_tpu/solvers``. The sampling solvers score
batches of rollouts; iLQR and SQP linearize the contact dynamics by
forward-mode AD (or batched central differences) on the oracle engine.
The receding-horizon runtime is ``runtime.mpc_runtime``.
"""

from . import cem, ilqr, mppi, rollout, sqp  # noqa: F401
from .cem import CEMConfig  # noqa: F401
from .ilqr import ILQRConfig, ILQRResult  # noqa: F401
from .mppi import MPPIConfig, PlanResult  # noqa: F401
from .sqp import SQPConfig, SQPResult  # noqa: F401
from .rollout import RolloutConfig, make_cost_fn  # noqa: F401
