"""Receding-horizon MPC runtime: plan -> apply -> shift.

Counterpart of ``quadruped_gym_tpu/runtime/mpc_runtime.py`` for the
sampling solvers (MPPI and CEM): the carry, one solve (``plan_and_act``)
and the two closed loops that drive a plant with it. SQP and iLQR are not
ported yet. Everything runs on the device of the carry's tensors; the
loops are Python loops that never read a tensor back, so the host only
enqueues work.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve_device
from ..models.spec import PhysicsModel
from ..physics import engine
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
    # the oracle plant's contact and Newton budgets (None: the model's)
    plant_max_contacts: int = 24
    plant_solver_iterations: Optional[int] = None

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


def _stack_traj(rows):
    """[(ctrl, sensordata, best_cost), ...] -> the three stacked over steps."""
    return tuple(torch.stack(col) for col in zip(*rows))


def closed_loop(
    m: PhysicsModel,
    cfg: MPCConfig,
    cost_fn: rollout_mod.CostFn,
    carry: MPCCarry,
    phys: State,
    cmd: Command,
    n_steps: int,
    plant_model: Optional[PhysicsModel] = None,
):
    """Run n_steps of receding-horizon control against an oracle-engine
    plant, on the device of ``carry`` and ``phys``.

    Returns (final_carry, final_phys, stacked per-step (ctrl, sensordata,
    best_cost)). ``plant_model`` lets the plant integrate a different (e.g.
    full-collision) model than the planner."""
    pm_plant = plant_model if plant_model is not None else m
    rows = []
    for _ in range(n_steps):
        ctrl, carry, info = plan_and_act(m, cfg, cost_fn, carry, phys, cmd)
        phys = engine.control_step(
            pm_plant, phys, ctrl, cfg.plant_frame_skip,
            max_contacts=cfg.plant_max_contacts,
            solver_iterations=cfg.plant_solver_iterations,
        )
        rows.append((ctrl, phys.sensordata, info["best_cost"]))
    return carry, phys, _stack_traj(rows)


def delayed_closed_loop(
    m: PhysicsModel,
    cfg: MPCConfig,
    cost_fn: rollout_mod.CostFn,
    carry: MPCCarry,
    phys: State,
    cmd: Command,
    n_steps: int,
    plant_model: Optional[PhysicsModel] = None,
    predictor: str = "auto",
    plant_engine: str = "aos",
):
    """Closed loop with a one-control-period computation delay: the
    real-time MPC pipeline pattern.

    ``closed_loop`` assumes the solve is instantaneous (plan from x_t,
    apply at t). On hardware the solve takes real time, so the pipelined
    controller plans the control for step t+1 WHILE step t's control is
    being actuated: the solve starts from the one-step PREDICTION
    x_{t+1} = f(x_t, u_t) under the planner model, and its result is
    applied one period later. Step 0 applies ``carry.prev_ctrl``.

    Returns (final_carry, final_phys, stacked per-step
    (applied_ctrl, sensordata, best_cost)).

    ``predictor`` selects the engine for the one-step state prediction
    (controller-side work): "lane" the batch-minor leg engine, "aos" the
    oracle engine with the rollout config's budgets, "auto" picks lane
    when the model is leg-compatible and the planner itself scores
    through a lane engine.

    ``plant_engine`` selects the engine simulating the plant: "aos" (the
    default, mj_step-parity semantics) or "lane", which routes the plant
    through the leg engine too."""
    from ..ops import leg_engine

    pm_plant = plant_model if plant_model is not None else m
    rcfg = cfg.rollout
    solver_cfg = {"mppi": cfg.mppi, "cem": cfg.cem}[cfg.solver]
    if predictor == "auto":
        predictor = ("lane" if solver_cfg.lane and leg_engine.is_compatible(m)
                     else "aos")
    if predictor == "lane":
        # Newton/line-search budget of the one-step prediction: the
        # sampling solver's own lane budget

        def predict(phys, pending):
            return lane_control_step(
                m, phys, pending, cfg.plant_frame_skip,
                solver_iterations=solver_cfg.lane_newton_iterations,
                ls_iterations=solver_cfg.lane_ls_iterations,
            )
    elif predictor == "aos":

        def predict(phys, pending):
            return engine.control_step(
                m, phys, pending, cfg.plant_frame_skip,
                max_contacts=rcfg.max_contacts,
                solver_iterations=rcfg.solver_iterations,
            )
    else:
        raise ValueError(f"unknown predictor {predictor!r}")

    if plant_engine == "lane":
        if not leg_engine.is_compatible(pm_plant):
            raise ValueError(
                "plant_engine='lane' needs a leg-compatible plant model"
            )
        p_newton = cfg.plant_solver_iterations or 4

        def plant_step(phys, pending):
            return lane_control_step(
                pm_plant, phys, pending, cfg.plant_frame_skip,
                solver_iterations=p_newton, ls_iterations=2 * p_newton,
            )
    elif plant_engine == "aos":

        def plant_step(phys, pending):
            return engine.control_step(
                pm_plant, phys, pending, cfg.plant_frame_skip,
                max_contacts=cfg.plant_max_contacts,
                solver_iterations=cfg.plant_solver_iterations,
            )
    else:
        raise ValueError(f"unknown plant_engine {plant_engine!r}")

    pending = carry.prev_ctrl
    rows = []
    for _ in range(n_steps):
        # predict the state after the currently-actuating control: the
        # planner model plays the role of the onboard predictor
        pred = predict(phys, pending)
        # the solve that (on hardware) overlaps this control period
        ctrl_next, carry, info = plan_and_act(m, cfg, cost_fn, carry, pred,
                                              cmd)
        # meanwhile the real plant advances under the pending control
        phys = plant_step(phys, pending)
        rows.append((pending, phys.sensordata, info["best_cost"]))
        pending = ctrl_next
    return carry, phys, _stack_traj(rows)
