"""The plain reference of one MPPI solve through ``plan_and_act``.

What the port's timed path computes, written again in eager PyTorch over
the frozen copies in this folder: the sampling noise drawn from the
solve's seed, the clamp to the actuators' range, the rollout costs (the
leg engine's ``control_step`` and the walking stage cost, H control
steps of ``frame_skip`` substeps at a fixed Newton / line-search
budget), the MPPI weighting and mean update, the applied control and the
receding-horizon shift of the plan.

Several solves, each with its own start state, plan, previous control and
noise seed, are scored in ONE batched pass: the lane axis holds every
solve's S rollouts one after another. The eager engine issues the same
operations whatever the batch (about 19k a substep on the planning
model), so a pass over many solves costs about what one costs.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import leg_engine, rewards
from .commands import Command
from .lane_engine import LaneState
from .spec import PhysicsModel


class SolveInput(NamedTuple):
    """One solve as the benchmark handed it to the program."""

    qpos: torch.Tensor  # (nq,)
    qvel: torch.Tensor  # (nv,)
    act: torch.Tensor  # (na,)
    time: torch.Tensor  # ()
    sensordata: torch.Tensor  # (nsens,)
    mean: torch.Tensor  # (H, nu) the plan the solve starts from
    prev_ctrl: torch.Tensor  # (nu,)
    noise_seed: int  # the seed of the solve's torch.Generator


class SolveOutput(NamedTuple):
    """What ``plan_and_act`` returns for one solve."""

    ctrl: torch.Tensor  # (nu,) the control to apply
    carry_mean: torch.Tensor  # (H, nu) the shifted plan
    best_cost: torch.Tensor  # ()
    mean_cost: torch.Tensor  # ()


def walking_stage_cost(sl, sens, ctrl, prev_ctrl, cmd: Command,
                       height: float = 0.13):
    """The exact (eps = 0) walking stage cost of
    ``quadruped_gym_tpu_torch/solvers/rollout.py``, component axis first."""
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
    reward = reward - 200.0 * (sens[sl.zaxis + 2] < 0).to(sens.dtype)
    return -reward


def rollout_costs(m: PhysicsModel, ls: LaneState, seqs: torch.Tensor,
                  prev: torch.Tensor, cmd: Command, frame_skip: int,
                  newton: int, line_search: int) -> torch.Tensor:
    """(N,) total costs of N lanes, each from its own start state in
    ``ls`` under its (H, nu, N) controls ``seqs``, ``prev`` the (nu, N)
    controls applied before the first step."""
    sl = rewards.SensorSlices.from_model(m)
    total = torch.zeros(seqs.shape[-1], dtype=seqs.dtype, device=seqs.device)
    for t in range(seqs.shape[0]):
        ls = leg_engine.control_step(m, ls, seqs[t], frame_skip,
                                     solver_iterations=newton,
                                     ls_iterations=line_search)
        total = total + walking_stage_cost(sl, ls.sensordata, seqs[t], prev,
                                           cmd)
        prev = seqs[t]
    return total


def weighted_update(seqs: torch.Tensor, costs: torch.Tensor,
                    temperature: float):
    """MPPI's weighting: non-finite costs count as +inf, softmax of
    -(cost - min) / temperature, the weighted mean of the (S, H, nu)
    sequences. Returns (new_mean, best_cost, mean_cost)."""
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    cmin = torch.min(costs)
    w = torch.softmax(-(costs - cmin) / temperature, dim=0)
    new_mean = torch.sum(w[:, None, None] * seqs, dim=0)
    return new_mean, cmin, torch.mean(costs)


def noise(seed: int, shape, dtype, device) -> torch.Tensor:
    """The standard normals a solve's generator gives first: a
    ``torch.Generator`` on ``device`` seeded with ``seed``, one draw of
    ``shape`` in ``dtype`` (the configuration's type)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def sample_costs(m: PhysicsModel, inputs: Sequence[SolveInput], cmd: Command,
                 num_samples: int, sigma: float, frame_skip: int,
                 newton: int, line_search: int, noise_dtype: torch.dtype,
                 dtype: torch.dtype, block: int = 4):
    """Each solve's (S, H, nu) clamped sequences and (S,) rollout costs,
    computed in ``dtype``, ``block`` solves a pass. The noise is drawn in
    ``noise_dtype`` on the inputs' device, as the program draws it, and
    cast."""
    lo = torch.as_tensor(np.asarray(m.actuator_ctrlrange[:, 0]))
    hi = torch.as_tensor(np.asarray(m.actuator_ctrlrange[:, 1]))
    S = num_samples
    for b0 in range(0, len(inputs), block):
        part = inputs[b0:b0 + block]
        dev = part[0].mean.device
        lo_d, hi_d = lo.to(dev, dtype), hi.to(dev, dtype)
        seqs = []
        for x in part:
            H, nu = x.mean.shape
            eps = sigma * noise(x.noise_seed, (S, H, nu), noise_dtype,
                                dev).to(dtype)
            seqs.append(torch.clamp(x.mean.to(dtype)[None] + eps, lo_d, hi_d))
        seqs = torch.cat(seqs)  # (len(part) * S, H, nu)

        def lanes(field):
            cols = [getattr(x, field).to(dtype)[:, None].expand(-1, S)
                    for x in part]
            return torch.cat(cols, dim=1).contiguous()

        ls = LaneState(
            qpos=lanes("qpos"), qvel=lanes("qvel"), act=lanes("act"),
            time=torch.cat([x.time.to(dtype).expand(S) for x in part]),
            sensordata=lanes("sensordata"))
        cmd_d = Command(*(c.to(dev, dtype) for c in cmd))
        costs = rollout_costs(m, ls, seqs.permute(1, 2, 0).contiguous(),
                              lanes("prev_ctrl"), cmd_d, frame_skip, newton,
                              line_search)
        for i in range(len(part)):
            sl = slice(i * S, (i + 1) * S)
            yield seqs[sl], costs[sl]
        del seqs, ls, costs


def solve(m: PhysicsModel, inputs: Sequence[SolveInput], cmd: Command,
          num_samples: int, sigma: float, temperature: float,
          frame_skip: int, newton: int, line_search: int,
          noise_dtype: torch.dtype, dtype: torch.dtype,
          block: int = 4) -> list:
    """The solves' outputs, computed in ``dtype``: ``block`` solves a
    pass (``sample_costs``), then MPPI's update and the shift."""
    out = []
    for seqs, costs in sample_costs(m, inputs, cmd, num_samples, sigma,
                                    frame_skip, newton, line_search,
                                    noise_dtype, dtype, block):
        mean, best, mean_cost = weighted_update(seqs, costs, temperature)
        out.append(SolveOutput(
            ctrl=mean[0], carry_mean=torch.cat([mean[1:], mean[-1:]], dim=0),
            best_cost=best, mean_cost=mean_cost))
    return out
