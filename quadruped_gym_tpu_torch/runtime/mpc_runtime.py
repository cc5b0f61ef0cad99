"""Receding-horizon MPC runtime: plan -> apply -> shift.

Counterpart of ``MPCConfig``, ``MPCCarry``, ``init_carry``,
``lane_control_step`` and ``plan_and_act`` in
``quadruped_gym_tpu/runtime/mpc_runtime.py``, for the sampling solvers
(MPPI and CEM). SQP, iLQR and the closed loops are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.spec import PhysicsModel
from ..physics.engine import State
from ..solvers import cem as cem_mod
from ..solvers import mppi as mppi_mod
from ..solvers import rollout as rollout_mod
from ..tasks.commands import Command

_PORTED_SOLVERS = ("mppi", "cem")


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    solver: str = "mppi"  # "mppi" | "cem" ("sqp" and "ilqr" are not ported)
    mppi: mppi_mod.MPPIConfig = mppi_mod.MPPIConfig()
    cem: cem_mod.CEMConfig = cem_mod.CEMConfig()
    # plant (the "real" robot) stepping
    plant_frame_skip: int = 5

    def __post_init__(self):
        if self.solver not in _PORTED_SOLVERS:
            raise NotImplementedError(
                f"solver {self.solver!r} is not ported yet "
                "(ROADMAP.md A.13); use 'mppi' or 'cem'")

    @property
    def rollout(self) -> rollout_mod.RolloutConfig:
        return {"mppi": self.mppi.rollout,
                "cem": self.cem.rollout}[self.solver]


class MPCCarry(NamedTuple):
    mean: torch.Tensor  # (H, nu) warm-started plan
    sigma: torch.Tensor  # (H, nu) CEM distribution scale
    prev_ctrl: torch.Tensor  # (nu,)
    generator: torch.Generator  # the solver's noise stream


def init_carry(m: PhysicsModel, cfg: MPCConfig, horizon: int, seed: int,
               dtype=torch.float32, device=None) -> MPCCarry:
    """Standing-pose plan; the generator lives on ``device`` and is
    seeded with ``seed``."""
    device = resolve_device(device)
    centers = torch.as_tensor(np.array([0.0, 0.0, -0.5] * 4), dtype=dtype,
                              device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return MPCCarry(
        mean=centers[None].repeat(horizon, 1),
        sigma=torch.full((horizon, m.nu), cfg.cem.init_sigma, dtype=dtype,
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
    if cfg.solver == "mppi":
        res = mppi_mod.plan(m, cfg.mppi, cost_fn, phys, carry.mean, cmd,
                            carry.prev_ctrl, carry.generator)
        mean, sigma = res.mean, carry.sigma
    elif cfg.solver == "cem":
        res = cem_mod.plan(m, cfg.cem, cost_fn, phys, carry.mean, cmd,
                           carry.prev_ctrl, carry.generator,
                           sigma=carry.sigma)
        mean, sigma = res.mean, res.sigma
    else:
        raise ValueError(cfg.solver)
    info = {"best_cost": res.best_cost, "mean_cost": res.mean_cost}
    ctrl = mean[0]
    # receding-horizon shift: roll the plan left, repeat the last step
    mean = torch.cat([mean[1:], mean[-1:]], dim=0)
    new_carry = MPCCarry(mean=mean, sigma=sigma, prev_ctrl=ctrl,
                         generator=carry.generator)
    return ctrl, new_carry, info
