"""The velocity/heading-command walking task as reset/step functions on a
batch of environments.

Counterpart of ``quadruped_gym_tpu/tasks/walking.py`` with every piece of
env-object state an explicit carry. Where the JAX package vmaps a
per-sample function over environments, the functions here work on a
leading env axis directly: every field of ``WalkingState`` is
(num_envs, ...). Random keys become a ``torch.Generator`` that the caller
holds, so ``WalkingState`` has no ``key``.

Step ordering matches the reference exactly: ideal-position integration
and the frequency/amplitude-estimator update (fed the *previous* applied
ctrl) happen before the physics substeps; the settling mask overrides
early actions; rewards read the post-step sensordata.

Cross-episode persistence quirks preserved: the estimator state and the
frozen control-cost reference survive reset.

``step`` runs the physics on the oracle engine (the JAX package's
per-sample ``step`` under ``vmap``), ``batched_step`` through the
batch-minor engines; the task layer around the physics is the same code.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .._device import resolve_device
from ..models.spec import PhysicsModel
from ..ops import cuda_engine
from ..physics import engine, smooth
from ..physics.engine import State, make_state
from . import commands, estimator, observations, rewards
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class WalkingConfig:
    """Static task configuration (constructor kwargs in the reference)."""

    max_time: float = 10.0
    frame_skip: int = 4
    settling_time: float = 0.0
    random_controls: bool = False
    random_init: bool = False
    reset_options: commands.SampleOptions = commands.SampleOptions()
    obs_window: int = 1  # PO variant frame stacking
    partial_obs: bool = False
    max_contacts: int = 24  # the oracle engine's contact budget (``step``)
    solver_iterations: Optional[int] = None
    min_freq: float = 1.0  # estimator config
    ema_alpha: float = 0.80
    dtype: torch.dtype = torch.float32

    def control_dt(self, m: PhysicsModel) -> float:
        return m.timestep * self.frame_skip


class WalkingState(NamedTuple):
    phys: State  # fields (N, ...)
    cmd: commands.Command
    ideal_position: torch.Tensor  # (N, 3)
    est: estimator.FreqAmpState
    rew: rewards.RewardCarry
    obs: observations.PoObsCarry  # Madgwick quat + frame stack (PO)
    applied_ctrl: torch.Tensor  # (N, 12) data.ctrl equivalent


class StepOutput(NamedTuple):
    state: WalkingState
    obs: torch.Tensor  # (N, obs_size)
    reward: torch.Tensor  # (N,)
    terminated: torch.Tensor  # (N,) bool
    reward_components: torch.Tensor  # (N, 11) ordered as rewards.REWARD_KEYS


def obs_size(cfg: WalkingConfig, m: PhysicsModel) -> int:
    if cfg.partial_obs:
        return observations.PO_OBS_DIM * cfg.obs_window
    return m.nsensordata


def _fresh_persistent(cfg: WalkingConfig, m: PhysicsModel, num_envs, device):
    W = estimator.window_size(cfg.min_freq, cfg.control_dt(m))
    est = estimator.init(m.nu, W, dtype=cfg.dtype, device=device,
                         batch_shape=(num_envs,))
    rew = rewards.init_carry(dtype=cfg.dtype, device=device,
                             batch_shape=(num_envs,))
    return est, rew


def reset(
    m: PhysicsModel,
    cfg: WalkingConfig,
    num_envs: int,
    generator: torch.Generator,
    persistent: Optional[Tuple[estimator.FreqAmpState,
                               rewards.RewardCarry]] = None,
    options: Optional[commands.SampleOptions] = None,
) -> Tuple[WalkingState, torch.Tensor]:
    """Reset ``num_envs`` episodes on the generator's device.
    ``persistent`` carries the estimator/ctrl-cost state across episodes
    (reference behavior); omit for a cold start."""
    dt, N = cfg.dtype, num_envs
    dev = resolve_device(generator.device)
    sl = rewards.SensorSlices.from_model(m)

    one = make_state(m, dtype=dt, device=dev)
    phys = State(*(x.expand((N,) + x.shape).clone() for x in one))
    # reset control
    ctrl0 = rewards.joint_centers(dt, dev, (N,))

    if cfg.random_init:
        # random base yaw: angle ~ U(0, 2pi)
        angle = 2.0 * math.pi * torch.rand(N, generator=generator, dtype=dt,
                                           device=dev)
        zero = torch.zeros_like(angle)
        quat = torch.stack([torch.cos(angle / 2), zero, zero,
                            torch.sin(angle / 2)], dim=-1)
        qpos = phys.qpos.clone()
        qpos[:, 3:7] = quat
        phys = phys._replace(qpos=qpos)

    if cfg.random_controls:
        opts = options if options is not None else cfg.reset_options
        cmd = commands.sample(generator, opts, dtype=dt, batch_shape=(N,))
    else:
        cmd = commands.zero(dtype=dt, device=dev, batch_shape=(N,))

    est, rew = (persistent if persistent is not None
                else _fresh_persistent(cfg, m, N, dev))
    rew = rewards.episode_reset_carry(rew)

    obs_carry = observations.po_init_carry(cfg.obs_window, dtype=dt,
                                           device=dev, batch_shape=(N,))
    # PO reset obs computed with the STALE filter quat
    if cfg.partial_obs:
        filled = cuda_engine.po_window(
            sl, phys.sensordata, ctrl0, cmd, obs_carry, phys.time,
            cfg.settling_time, cfg.control_dt(m), fill=True,
        )
        obs_carry = observations.PoObsCarry(
            mad_quat=phys.qpos[:, 3:7],  # re-seed from the true orientation
            buffer=filled.buffer,
        )
        obs = obs_carry.buffer.reshape(N, -1)
    else:
        obs = phys.sensordata

    state = WalkingState(
        phys=phys,
        cmd=cmd,
        ideal_position=torch.zeros((N, 3), dtype=dt, device=dev),
        est=est,
        rew=rew,
        obs=obs_carry,
        applied_ctrl=ctrl0,
    )
    return state, obs


def _task_step(
    m: PhysicsModel,
    cfg: WalkingConfig,
    state: WalkingState,  # leading axis N
    action: torch.Tensor,  # (N, nu)
    physics: Callable[[State, torch.Tensor], State],
) -> StepOutput:
    """One control step of every environment; ``physics(phys, ctrl)``
    advances the (N, ...) physics state a control period under the
    clipped (N, nu) controls."""
    with profiling.span("walking.task_step"):
        dt = cfg.dtype
        sl = rewards.SensorSlices.from_model(m)
        cdt = cfg.control_dt(m)
        N = action.shape[0]

        # 1. ideal-position integration
        # (N, 3)
        ideal = state.ideal_position + state.cmd.global_velocity * cdt

        # 2. estimator update on the PREVIOUS applied ctrl
        est, f_est, a_est = estimator.update(state.est, state.applied_ctrl,
                                             cdt, cfg.ema_alpha)

        # 3. settling mask
        centers = rewards.joint_centers(dt, action.device)
        action = torch.where((state.phys.time < cfg.settling_time)[:, None],
                             centers[None], action)

        # 4. clip + physics substeps
        ctrl = smooth.clip_ctrl(m, action.to(dt))
        with profiling.span("walking.physics"):
            phys = physics(state.phys, ctrl)

        # 5. reward on post-step sensordata
        out = rewards.input_control_reward(
            phys.sensordata, ctrl, state.cmd, ideal, f_est, a_est, state.rew,
            sl, cdt)

        # 6. termination: flip OR time limit
        terminated = (rewards.flip_termination(phys.sensordata.T, sl)
                      | rewards.time_termination(phys.time, cfg.max_time))

        # 7. observation
        if cfg.partial_obs:
            obs_carry = cuda_engine.po_window(
                sl, phys.sensordata, ctrl, state.cmd, state.obs, phys.time,
                cfg.settling_time, cdt,
            )
            obs = obs_carry.buffer.reshape(N, -1)
        else:
            obs_carry = state.obs
            obs = phys.sensordata

        new_state = WalkingState(
            phys=phys,
            cmd=state.cmd,
            ideal_position=ideal,
            est=est,
            rew=out.carry,
            obs=obs_carry,
            applied_ctrl=ctrl,
        )
        return StepOutput(
            state=new_state,
            obs=obs,
            reward=out.total,
            terminated=terminated,
            reward_components=out.components,
        )


def step(m: PhysicsModel, cfg: WalkingConfig, state: WalkingState,
         action: torch.Tensor) -> StepOutput:
    """One control step of every environment on the oracle engine, with
    ``cfg.max_contacts`` and ``cfg.solver_iterations``: the JAX package's
    per-sample ``step`` mapped over the leading env axis."""

    def physics(phys, ctrl):
        return engine.control_step(
            m, phys, ctrl, cfg.frame_skip,
            max_contacts=cfg.max_contacts,
            solver_iterations=cfg.solver_iterations,
        )

    return _task_step(m, cfg, state, action, physics)


def batched_engine(m: PhysicsModel, engine_impl: str):
    """The engine module that ``batched_step`` runs for ``engine_impl`` on
    ``m``: ``ops.cuda_engine`` for ``"pallas"`` on a leg-compatible model,
    ``ops.leg_engine`` for ``"leg"`` and ``"auto"`` on one,
    ``ops.lane_engine`` otherwise."""
    from ..ops import lane_engine, leg_engine

    if engine_impl not in ("auto", "leg", "pallas", "lane"):
        raise ValueError(f"unknown engine_impl {engine_impl!r}; "
                         "valid: 'auto', 'leg', 'pallas', 'lane'")
    if engine_impl == "pallas" and leg_engine.is_compatible(m):
        return cuda_engine
    if engine_impl == "leg" or (
            engine_impl == "auto" and leg_engine.is_compatible(m)):
        return leg_engine
    return lane_engine


def batched_step(
    m: PhysicsModel,
    cfg: WalkingConfig,
    state: WalkingState,  # leading axis N
    action: torch.Tensor,  # (N, nu)
    engine_impl: str = "auto",
    newton_iterations: Optional[int] = None,
    ls_iterations: int = 8,
) -> StepOutput:
    """One control step of every environment, physics through a
    batch-minor engine. ``engine_impl``: ``"pallas"`` keeps the JAX
    package's name for the substep kernel
    (``ops.cuda_engine.control_step``, one launch per call);
    ``"leg"``, and ``"auto"`` for a leg-compatible model, is the eager leg
    engine; ``"lane"``, and ``"auto"`` for any other model, the eager lane
    engine. ``"pallas"`` on a model that is not leg-compatible (legs that
    differ, a branch in a leg chain, a geom off the base and the legs;
    the robot's ``full`` model is compatible) warns and falls back to the
    lane engine. The Newton budget is a fixed iteration
    count: ``newton_iterations`` defaults to ``cfg.solver_iterations``
    (or 4 when that is None)."""
    from ..ops import lane_engine

    if newton_iterations is None:
        newton_iterations = cfg.solver_iterations or 4
    eng = batched_engine(m, engine_impl)
    if engine_impl == "pallas" and eng is not cuda_engine:
        warnings.warn(
            "engine_impl='pallas' needs a leg-compatible model "
            "(leg_engine.is_compatible); falling back to the slower "
            "lane engine",
            stacklevel=2,
        )

    def physics(phys, ctrl):
        ls = lane_engine.from_batched(*phys)
        ls = eng.control_step(
            m, ls, ctrl.T, cfg.frame_skip,
            solver_iterations=newton_iterations, ls_iterations=ls_iterations,
        )
        return State(*lane_engine.to_batched(ls))

    return _task_step(m, cfg, state, action, physics)
