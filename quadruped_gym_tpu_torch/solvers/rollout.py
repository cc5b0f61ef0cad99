"""Batched rollout scoring + the walking stage cost for sampling MPC.

Counterpart of ``RolloutConfig``, ``walking_stage_cost``, ``make_cost_fn``
and ``lane_batched_rollout_cost`` in
``quadruped_gym_tpu/solvers/rollout.py``. The stage cost works on one
sample (sensordata (33,)) or on a lane batch (33, S) alike.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.spec import PhysicsModel
from ..physics.engine import State
from ..tasks import rewards
from ..tasks.commands import Command


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    horizon: int = 50  # control steps per rollout
    frame_skip: int = 5  # physics substeps per control step (10 ms at 2 ms h)


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
    ``make_cost_fn(m)``, whose math the kernel hard-wires). ``"leg"``
    loops the eager leg engine with ``cost_fn``. ``"pallas"`` and
    ``"lane"`` are not ported yet."""
    from ..ops import leg_engine

    if engine_impl not in ("lane", "leg", "pallas", "fused"):
        raise ValueError(
            f"unknown engine_impl {engine_impl!r}; "
            "valid: 'lane', 'leg', 'pallas', 'fused'"
        )
    if engine_impl in ("pallas", "lane"):
        raise NotImplementedError(
            f"engine_impl={engine_impl!r} is not ported yet "
            "(ROADMAP.md: B2 / A.10)")
    if not leg_engine.is_compatible(m):
        raise NotImplementedError(
            "the model is not leg-compatible; its engine (the lane engine) "
            "is not ported yet (ROADMAP.md A.10)")
    if engine_impl == "fused":
        from ..ops import cuda_engine

        if not getattr(cost_fn, "_is_walking_stage_cost", False):
            raise ValueError(
                "engine_impl='fused' hard-wires the walking stage cost "
                "inside the kernel; a custom cost_fn would be silently "
                "ignored. Use make_cost_fn(m), or engine_impl='leg' "
                "for custom costs."
            )
        return cuda_engine.fused_rollout_cost(
            m, state0, ctrl_seqs, cmd, prev_ctrl0, cfg.frame_skip,
            solver_iterations=newton_iterations,
            ls_iterations=ls_iterations, dp=dp,
        )

    from ..ops.lane_engine import LaneState

    S, H, nu = ctrl_seqs.shape
    dt = ctrl_seqs.dtype

    def lanes(x):
        return x.to(dt)[:, None].expand(x.shape[0], S)

    ls = LaneState(qpos=lanes(state0.qpos), qvel=lanes(state0.qvel),
                   act=lanes(state0.act),
                   time=state0.time.to(dt).expand(S),
                   sensordata=lanes(state0.sensordata))
    seqs = ctrl_seqs.permute(1, 2, 0)  # (H, nu, S)
    prev = lanes(prev_ctrl0)
    total = torch.zeros(S, dtype=dt, device=ctrl_seqs.device)
    for t in range(H):
        ls = leg_engine.control_step(
            m, ls, seqs[t], cfg.frame_skip,
            solver_iterations=newton_iterations,
            ls_iterations=ls_iterations, dp=dp,
        )
        total = total + cost_fn(ls.sensordata, seqs[t], prev, cmd)
        prev = seqs[t]
    return total
