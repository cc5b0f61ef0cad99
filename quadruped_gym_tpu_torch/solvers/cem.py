"""Cross-Entropy Method sampling MPC.

Counterpart of ``quadruped_gym_tpu/solvers/cem.py``: sample control
sequences from a diagonal Gaussian, refit it to the elite fraction, and
return the refined mean and scale. The noise comes from a
``torch.Generator``; the refit is ``refit``, which the tests feed given
sequences and costs. Same batched rollout backend as MPPI.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from ..models.spec import PhysicsModel
from ..physics.engine import State
from ..tasks.commands import Command
from . import rollout as rollout_mod
from .mppi import _ctrl_bounds, _rollout_costs


@dataclasses.dataclass(frozen=True)
class CEMConfig:
    num_samples: int = 1024
    num_elites: int = 64
    iterations: int = 3
    init_sigma: float = 0.3
    min_sigma: float = 0.02
    alpha: float = 0.2  # distribution smoothing (old vs refit)
    rollout: rollout_mod.RolloutConfig = rollout_mod.RolloutConfig()
    # lane=True scores rollouts through the batch-minor engines,
    # lane=False through the oracle engine
    lane: bool = False
    lane_newton_iterations: int = 4
    lane_engine_impl: str = "leg"
    lane_ls_iterations: int = 8


class CEMResult(NamedTuple):
    mean: torch.Tensor  # (H, nu)
    sigma: torch.Tensor  # (H, nu)
    best_cost: torch.Tensor
    mean_cost: torch.Tensor


def refit(seqs: torch.Tensor, costs: torch.Tensor, mean: torch.Tensor,
          sigma: torch.Tensor, cfg: CEMConfig):
    """One CEM distribution update (cem.py:80-89 of the JAX package):
    non-finite costs count as +inf, the ``num_elites`` cheapest of the
    (S, H, nu) sequences are refit by their mean and their population
    standard deviation (divisor N), smoothed with the old distribution
    by ``alpha`` and floored at ``min_sigma``. Returns (mean, sigma,
    best_cost, mean_cost)."""
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    _, elite_idx = torch.topk(-costs, cfg.num_elites)
    elites = seqs[elite_idx]
    new_mean = torch.mean(elites, dim=0)
    new_sigma = torch.std(elites, dim=0, correction=0)
    mean = cfg.alpha * mean + (1 - cfg.alpha) * new_mean
    sigma = torch.clamp_min(
        cfg.alpha * sigma + (1 - cfg.alpha) * new_sigma, cfg.min_sigma)
    return mean, sigma, torch.min(costs), torch.mean(costs)


def plan(
    m: PhysicsModel,
    cfg: CEMConfig,
    cost_fn: rollout_mod.CostFn,
    state: State,
    mean: torch.Tensor,  # (H, nu)
    cmd: Command,
    prev_ctrl: torch.Tensor,
    generator: torch.Generator,
    sigma: Optional[torch.Tensor] = None,
) -> CEMResult:
    dtype, dev = mean.dtype, mean.device
    lo, hi = _ctrl_bounds(m, dtype, dev)
    if sigma is None:
        sigma = torch.full_like(mean, cfg.init_sigma)
    best = mean_c = None
    for _ in range(cfg.iterations):
        eps = torch.randn((cfg.num_samples,) + mean.shape,
                          generator=generator, dtype=dtype, device=dev)
        seqs = torch.clamp(mean[None] + sigma[None] * eps, lo, hi)
        costs = _rollout_costs(m, cfg, cost_fn, state, seqs, cmd, prev_ctrl)
        mean, sigma, best, mean_c = refit(seqs, costs, mean, sigma, cfg)
    return CEMResult(mean=mean, sigma=sigma, best_cost=best, mean_cost=mean_c)
