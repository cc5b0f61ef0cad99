"""MPPI (Model-Predictive Path Integral) sampling MPC.

Counterpart of ``quadruped_gym_tpu/solvers/mppi.py``: sample control
perturbations, score the rollouts, weight them exponentially by cost and
update the mean sequence. The noise comes from a ``torch.Generator``; the
weighting and mean update are ``weighted_update``, which the tests feed
given sequences and costs. The receding-horizon shift lives in
``runtime.mpc_runtime``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..models.spec import PhysicsModel
from ..physics.engine import State
from ..tasks.commands import Command
from . import rollout as rollout_mod


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    num_samples: int = 1024
    sigma: float = 0.3  # exploration std (in ctrl units)
    temperature: float = 1.0  # lambda in the MPPI weighting
    iterations: int = 1  # refinement iterations per solve
    rollout: rollout_mod.RolloutConfig = rollout_mod.RolloutConfig()
    # lane=True scores rollouts through the batch-minor engines with the
    # fixed Newton budget below instead of the rollout config's
    # solver_iterations; lane=False through the oracle engine
    lane: bool = False
    lane_newton_iterations: int = 4
    lane_ls_iterations: int = 8
    # "fused" (the CUDA whole-rollout kernel, walking stage cost only),
    # "pallas" (the substep kernel per control step, any cost_fn) or "leg"
    # (eager engine)
    lane_engine_impl: str = "leg"


class PlanResult(NamedTuple):
    mean: torch.Tensor  # (H, nu) updated mean control sequence
    best_cost: torch.Tensor
    mean_cost: torch.Tensor
    weights_entropy: torch.Tensor


def _ctrl_bounds(m: PhysicsModel, dtype, device):
    lo = torch.as_tensor(np.asarray(m.actuator_ctrlrange[:, 0]), dtype=dtype,
                         device=device)
    hi = torch.as_tensor(np.asarray(m.actuator_ctrlrange[:, 1]), dtype=dtype,
                         device=device)
    return lo, hi


def weighted_update(seqs: torch.Tensor, costs: torch.Tensor,
                    temperature: float):
    """The MPPI weighting (mppi.py:92-96 of the JAX package): non-finite
    costs count as +inf, softmax of -(cost - min)/temperature, weighted
    mean of the (S, H, nu) sequences. Returns (new_mean, best_cost,
    mean_cost, weights_entropy)."""
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    cmin = torch.min(costs)
    w = torch.softmax(-(costs - cmin) / temperature, dim=0)
    new_mean = torch.einsum("s,shu->hu", w, seqs).to(seqs.dtype)
    ent = -torch.sum(w * torch.log(w + 1e-30))
    return new_mean, cmin, torch.mean(costs), ent


def _rollout_costs(m, cfg, cost_fn, state, seqs, cmd, prev):
    """(S,) rollout costs as an ``MPPIConfig`` or a ``CEMConfig`` asks for
    them: through a batch-minor engine or through the oracle engine."""
    if cfg.lane:
        return rollout_mod.lane_batched_rollout_cost(
            m, cfg.rollout, cost_fn, state, seqs, cmd, prev,
            newton_iterations=cfg.lane_newton_iterations,
            ls_iterations=cfg.lane_ls_iterations,
            engine_impl=cfg.lane_engine_impl,
        )
    return rollout_mod.batched_rollout_cost(
        m, cfg.rollout, cost_fn, state, seqs, cmd, prev
    )


def plan(
    m: PhysicsModel,
    cfg: MPPIConfig,
    cost_fn: rollout_mod.CostFn,
    state: State,
    mean: torch.Tensor,  # (H, nu)
    cmd: Command,
    prev_ctrl: torch.Tensor,  # (nu,)
    generator: torch.Generator,
) -> PlanResult:
    dtype, dev = mean.dtype, mean.device
    lo, hi = _ctrl_bounds(m, dtype, dev)
    S = cfg.num_samples
    H, nu = mean.shape
    stats = None
    for _ in range(cfg.iterations):
        eps = cfg.sigma * torch.randn((S, H, nu), generator=generator,
                                      dtype=dtype, device=dev)
        seqs = torch.clamp(mean[None] + eps, lo, hi)
        costs = _rollout_costs(m, cfg, cost_fn, state, seqs, cmd, prev_ctrl)
        mean, *stats = weighted_update(seqs, costs, cfg.temperature)
    best, mean_c, ent = stats
    return PlanResult(mean=mean, best_cost=best, mean_cost=mean_c,
                      weights_entropy=ent)
