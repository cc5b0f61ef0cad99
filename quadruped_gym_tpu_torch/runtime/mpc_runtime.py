"""Receding-horizon MPC runtime: plan -> apply -> shift.

Counterpart of ``MPCConfig``, ``MPCCarry``, ``init_carry``,
``lane_control_step`` and ``plan_and_act`` in
``quadruped_gym_tpu/runtime/mpc_runtime.py``, for the MPPI solver. CEM,
SQP, iLQR and the closed loops are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.spec import PhysicsModel
from ..physics.engine import State
from ..solvers import mppi as mppi_mod
from ..solvers import rollout as rollout_mod
from ..tasks.commands import Command

_PORTED_SOLVERS = ("mppi",)


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    solver: str = "mppi"  # only "mppi" is ported
    mppi: mppi_mod.MPPIConfig = mppi_mod.MPPIConfig()
    # plant (the "real" robot) stepping
    plant_frame_skip: int = 5

    def __post_init__(self):
        if self.solver not in _PORTED_SOLVERS:
            raise NotImplementedError(
                f"solver {self.solver!r} is not ported yet "
                "(ROADMAP.md A.9/A.13); use 'mppi'")

    @property
    def rollout(self) -> rollout_mod.RolloutConfig:
        return self.mppi.rollout


class MPCCarry(NamedTuple):
    mean: torch.Tensor  # (H, nu) warm-started plan
    sigma: torch.Tensor  # (H, nu) CEM distribution scale (unused by MPPI)
    prev_ctrl: torch.Tensor  # (nu,)
    generator: torch.Generator  # the solver's noise stream


def init_carry(m: PhysicsModel, cfg: MPCConfig, horizon: int, seed: int,
               dtype=torch.float32, device=None,
               init_sigma: float = 0.3) -> MPCCarry:
    """Standing-pose plan; the generator lives on ``device`` and is
    seeded with ``seed``."""
    device = resolve_device(device)
    centers = torch.as_tensor(np.array([0.0, 0.0, -0.5] * 4), dtype=dtype,
                              device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return MPCCarry(
        mean=centers[None].repeat(horizon, 1),
        sigma=torch.full((horizon, m.nu), init_sigma, dtype=dtype,
                         device=device),
        prev_ctrl=centers,
        generator=gen,
    )


def lane_control_step(
    m: PhysicsModel,
    phys: State,
    ctrl: torch.Tensor,
    frame_skip: int,
    solver_iterations: int = 4,
    ls_iterations: int = 8,
) -> State:
    """Advance ONE ``State`` a control period through the leg engine,
    duplicated across 8 lanes as the JAX package does."""
    from ..ops import leg_engine
    from ..ops.lane_engine import LaneState

    B = 8

    def lanes(x):
        return x[:, None].expand(x.shape[0], B)

    ls = LaneState(qpos=lanes(phys.qpos), qvel=lanes(phys.qvel),
                   act=lanes(phys.act), time=phys.time.expand(B),
                   sensordata=lanes(phys.sensordata))
    ls = leg_engine.control_step(
        m, ls, lanes(ctrl), frame_skip,
        solver_iterations=solver_iterations, ls_iterations=ls_iterations,
    )
    return State(qpos=ls.qpos[:, 0], qvel=ls.qvel[:, 0], act=ls.act[:, 0],
                 time=ls.time[0], sensordata=ls.sensordata[:, 0])


def plan_and_act(
    m: PhysicsModel,
    cfg: MPCConfig,
    cost_fn: rollout_mod.CostFn,
    carry: MPCCarry,
    phys: State,
    cmd: Command,
):
    """One MPC solve: returns (ctrl_to_apply, new_carry, info_dict). The
    carry's generator advances in place."""
    res = mppi_mod.plan(m, cfg.mppi, cost_fn, phys, carry.mean, cmd,
                        carry.prev_ctrl, carry.generator)
    mean = res.mean
    info = {"best_cost": res.best_cost, "mean_cost": res.mean_cost}
    ctrl = mean[0]
    # receding-horizon shift: roll the plan left, repeat the last step
    mean = torch.cat([mean[1:], mean[-1:]], dim=0)
    new_carry = MPCCarry(mean=mean, sigma=carry.sigma, prev_ctrl=ctrl,
                         generator=carry.generator)
    return ctrl, new_carry, info
