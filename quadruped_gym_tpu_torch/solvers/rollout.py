"""Batched rollout scoring + the walking stage cost for sampling MPC.

Counterpart of ``quadruped_gym_tpu/solvers/rollout.py``. The stage cost
works on one sample (sensordata (33,)) or on a lane batch (33, S) alike:
the component axis comes first.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import torch

from ..models.spec import PhysicsModel
from ..physics import engine
from ..physics.engine import State
from ..tasks import rewards
from ..tasks.commands import Command
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    horizon: int = 50  # control steps per rollout
    frame_skip: int = 5  # physics substeps per control step (10 ms at 2 ms h)
    # the oracle-engine paths' budgets (rollout_cost, batched_rollout_cost,
    # the "aos" predictor); the lane paths carry their own
    max_contacts: int = 12
    solver_iterations: Optional[int] = 8


# cost_fn(sens, ctrl, prev_ctrl, cmd) -> stage cost per lane
CostFn = Callable[..., torch.Tensor]


def walking_stage_cost(
    sl: rewards.SensorSlices,
    sens: torch.Tensor,
    ctrl: torch.Tensor,
    prev_ctrl: torch.Tensor,
    cmd: Command,
    vel_smooth_eps: float = 0.0,
    height: float = 0.13,
) -> torch.Tensor:
    """Negative of the stateless part of the task reward.

    ``vel_smooth_eps`` (m/s) smooths the progress terms' velocity norm:
    |v| -> sqrt(|v|^2 + eps^2). eps = 0 is the exact task reward (the
    sampling solvers' score, hard-wired into the fused kernel); the
    gradient solvers need eps > 0. ``height`` (m) is the body-height
    target."""
    if vel_smooth_eps > 0.0:
        v = sens[sl.vel: sl.vel + 2]
        c = cmd.velocity[:2]
        vn = torch.sqrt(v[0] * v[0] + v[1] * v[1]
                        + vel_smooth_eps * vel_smooth_eps)
        cn = torch.linalg.vector_norm(c)
        prog_dir = (v[0] * c[0] + v[1] * c[1]) / (vn * torch.clamp_min(cn, 1e-30))
        speed_cost = torch.square(vn - cn)
    else:
        prog_dir = rewards.progress_direction_reward_local(sens, sl, cmd)
        speed_cost = rewards.progress_speed_cost_local(sens, sl, cmd)
    reward = (
        +10.0 * rewards.alive_bonus(sens.dtype, sens.device)
        + 10.0 * prog_dir
        - 50.0 * speed_cost
        + 10.0 * rewards.exp_dist(rewards.heading_reward(sens, sl, cmd))
        + 10.0 * rewards.exp_dist(rewards.orientation_reward(sens, sl))
        - 50.0 * rewards.exp_dist(rewards.body_height_cost(sens, sl, height))
        - 1.0 * rewards.joint_posture_cost(ctrl)
        - 2.0 * torch.sum(torch.square(ctrl - prev_ctrl), dim=0)
    )
    # heavily penalize flipping inside the lookahead
    reward = reward - 200.0 * (sens[sl.zaxis + 2] < 0).to(sens.dtype)
    return -reward


def make_cost_fn(m: PhysicsModel, vel_smooth_eps: float = 0.0) -> CostFn:
    sl = rewards.SensorSlices.from_model(m)

    def fn(sens, ctrl, prev_ctrl, cmd):
        return walking_stage_cost(sl, sens, ctrl, prev_ctrl, cmd,
                                  vel_smooth_eps=vel_smooth_eps)

    # marker checked by the fused whole-rollout kernel, whose stage cost
    # is hard-wired to this function's exact (eps = 0) math
    fn._is_walking_stage_cost = vel_smooth_eps == 0.0
    return fn


def rollout_cost(
    m: PhysicsModel,
    cfg: RolloutConfig,
    cost_fn: CostFn,
    state0: State,
    ctrl_seq: torch.Tensor,  # (..., H, nu)
    cmd: Command,
    prev_ctrl0: torch.Tensor,  # (nu,) the last applied control
) -> torch.Tensor:
    """Total cost of H-step rollouts on the oracle engine from ``state0``
    under ``ctrl_seq``: a scalar for one (H, nu) sequence, (...,) costs for
    a batch of sequences, all rolled out in one batched pass."""
    batch = ctrl_seq.shape[:-2]
    st = State(*(x.expand(batch + x.shape) for x in state0))
    prev = prev_ctrl0.expand(batch + prev_ctrl0.shape)
    total = ctrl_seq.new_zeros(batch)
    for t in range(ctrl_seq.shape[-2]):
        ctrl = ctrl_seq[..., t, :]
        st = engine.control_step(
            m, st, ctrl, cfg.frame_skip,
            max_contacts=cfg.max_contacts,
            solver_iterations=cfg.solver_iterations,
        )
        # the stage cost wants the component axis first
        total = total + cost_fn(st.sensordata.movedim(-1, 0),
                                ctrl.movedim(-1, 0), prev.movedim(-1, 0), cmd)
        prev = ctrl
    return total


def batched_rollout_cost(
    m: PhysicsModel,
    cfg: RolloutConfig,
    cost_fn: CostFn,
    state0: State,
    ctrl_seqs: torch.Tensor,  # (S, H, nu)
    cmd: Command,
    prev_ctrl0: torch.Tensor,
) -> torch.Tensor:
    """(S,) total costs on the oracle engine from one shared start state:
    the sample axis is the engine's batch axis."""
    return rollout_cost(m, cfg, cost_fn, state0, ctrl_seqs, cmd, prev_ctrl0)


def lane_batched_rollout_cost(
    m: PhysicsModel,
    cfg: RolloutConfig,
    cost_fn: CostFn,
    state0: State,
    ctrl_seqs: torch.Tensor,  # (S, H, nu)
    cmd: Command,
    prev_ctrl0: torch.Tensor,
    newton_iterations: int = 4,
    ls_iterations: int = 8,
    engine_impl: str = "leg",
    dp=None,  # DomainParams of (S,) lanes
) -> torch.Tensor:
    """(S,) total costs of H-step rollouts from one shared start state.

    ``engine_impl="fused"`` runs the whole rollout (all H x frame_skip
    substeps plus the walking stage cost) in one CUDA kernel launch
    (``ops.cuda_engine.fused_rollout_cost``; ``cost_fn`` must be
    ``make_cost_fn(m)``, whose math the kernel hard-wires). ``"pallas"``
    keeps the JAX package's name for the per-control-step path: one
    launch of the substep kernel (``ops.cuda_engine.control_step``) per
    control step, then ``cost_fn`` on the sensors it wrote, so any stage
    cost works. ``"leg"`` loops the eager leg engine with ``cost_fn``.
    ``"lane"`` loops the eager lane engine, which serves every model: the
    other three need a leg-compatible model (``leg_engine.is_compatible``:
    identical legs on a free base, collision geoms on the legs and the
    base, the robot's ``full`` model included) and fall back to it, with
    a warning, on any other. ``dp`` needs one of those three."""
    with profiling.span("rollout.lane_batched_rollout_cost"):
        from ..ops import cuda_engine, lane_engine, leg_engine

        if engine_impl not in ("lane", "leg", "pallas", "fused"):
            raise ValueError(
                f"unknown engine_impl {engine_impl!r}; "
                "valid: 'lane', 'leg', 'pallas', 'fused'"
            )
        if engine_impl != "lane" and not leg_engine.is_compatible(m):
            warnings.warn(
                f"engine_impl={engine_impl!r} needs a leg-compatible "
                "model (leg_engine.is_compatible); falling "
                "back to the slower lane engine",
                stacklevel=2,
            )
            engine_impl = "lane"
        if dp is not None and engine_impl == "lane":
            raise ValueError(
                "DomainParams require the leg/pallas/fused engines "
                "(a leg-compatible model)"
            )
        if engine_impl == "fused":
            if not getattr(cost_fn, "_is_walking_stage_cost", False):
                raise ValueError(
                    "engine_impl='fused' hard-wires the walking stage cost "
                    "inside the kernel; a custom cost_fn would be silently "
                    "ignored. Use make_cost_fn(m), or engine_impl='pallas' "
                    "for custom costs."
                )
            return cuda_engine.fused_rollout_cost(
                m, state0, ctrl_seqs, cmd, prev_ctrl0, cfg.frame_skip,
                solver_iterations=newton_iterations,
                ls_iterations=ls_iterations, dp=dp,
            )

        S, H, nu = ctrl_seqs.shape
        dt = ctrl_seqs.dtype

        def lanes(x):
            return x.to(dt)[:, None].expand(x.shape[0], S)

        ls = lane_engine.LaneState(
            qpos=lanes(state0.qpos), qvel=lanes(state0.qvel),
            act=lanes(state0.act), time=state0.time.to(dt).expand(S),
            sensordata=lanes(state0.sensordata))
        seqs = ctrl_seqs.permute(1, 2, 0).contiguous()  # (H, nu, S)
        prev = lanes(prev_ctrl0)
        total = torch.zeros(S, dtype=dt, device=ctrl_seqs.device)
        eng = {"pallas": cuda_engine, "leg": leg_engine,
               "lane": lane_engine}[engine_impl]
        kw = {} if dp is None else {"dp": dp}
        for t in range(H):
            ls = eng.control_step(
                m, ls, seqs[t], cfg.frame_skip,
                solver_iterations=newton_iterations,
                ls_iterations=ls_iterations, **kw,
            )
            total = total + cost_fn(ls.sensordata, seqs[t], prev, cmd)
            prev = seqs[t]
        return total
