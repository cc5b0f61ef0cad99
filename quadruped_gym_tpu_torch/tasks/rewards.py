"""Reward & termination primitives of the walking task.

Counterpart of ``quadruped_gym_tpu/tasks/rewards.py``. Two layouts:

* the PRIMITIVES (every term, the terminations, ``unit``, ``control_cost``)
  take arrays whose FIRST axis is the component axis, so one sample,
  sensordata (33,), and a lane batch, (33, B), go through the same code,
  and the lane engines' batch-minor sensordata needs no transpose.
  Command vectors are (3,) and broadcast over the lanes, or (3, B);
* the COMPOSITES (``input_control_reward``, ``dummy_composite``) and the
  ``RewardCarry`` they thread take any leading batch axes with the
  component axis LAST, as the JAX package's vmapped functions do.

Deliberately preserved reference quirks:
  * ``progress_speed_reward_local`` uses the *second* definition (local
    velocimeter; the first is shadowed in the reference);
  * ``control_cost``'s EMA reference value is captured once on the very
    first call and never updated, and it is NOT reset between episodes;
  * the derivative reward term is zero on the first step of each episode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device
from ..models.spec import PhysicsModel
from .commands import Command

JOINT_CENTERS = np.array([0.0, 0.0, -0.5] * 4, dtype=np.float64)

REWARD_KEYS = (
    "alive_bonus",
    "control_cost",
    "progress_direction_reward_local",
    "progress_speed_cost_local",
    "heading_reward",
    "orientation_reward",
    "body_height_cost",
    "joint_posture_cost",
    "control_amplitude_cost",
    "control_frequency_cost",
    "diff_ideal_position_cost",
)


class SensorSlices(NamedTuple):
    accel: int
    gyro: int
    pos: int
    linvel: int
    xaxis: int
    zaxis: int
    vel: int

    @classmethod
    def from_model(cls, m: PhysicsModel) -> "SensorSlices":
        return cls(
            accel=m.sensor_adr("body_accel"),
            gyro=m.sensor_adr("body_gyro"),
            pos=m.sensor_adr("body_pos"),
            linvel=m.sensor_adr("body_linvel"),
            xaxis=m.sensor_adr("body_xaxis"),
            zaxis=m.sensor_adr("body_zaxis"),
            vel=m.sensor_adr("body_vel"),
        )


class RewardCarry(NamedTuple):
    """State the reference keeps on the env object, made explicit."""

    previous_ctrl: torch.Tensor  # (..., 12)
    ctrl_cost_ref: torch.Tensor  # (...,) frozen first control cost
    ctrl_cost_ref_set: torch.Tensor  # (...,) bool
    prev_rewards_to_derive: torch.Tensor  # (..., 1) [-20 * ideal_position_cost]
    has_prev_derive: torch.Tensor  # (...,) bool


def joint_centers(dtype, device, batch_shape=()) -> torch.Tensor:
    c = torch.as_tensor(JOINT_CENTERS, dtype=dtype, device=device)
    return c.expand(tuple(batch_shape) + (12,)).clone()


def init_carry(dtype=torch.float32, device=None,
               batch_shape=()) -> RewardCarry:
    device = resolve_device(device)
    bs = tuple(batch_shape)
    return RewardCarry(
        previous_ctrl=joint_centers(dtype, device, bs),
        ctrl_cost_ref=torch.zeros(bs, dtype=dtype, device=device),
        ctrl_cost_ref_set=torch.zeros(bs, dtype=torch.bool, device=device),
        prev_rewards_to_derive=torch.zeros(bs + (1,), dtype=dtype,
                                           device=device),
        has_prev_derive=torch.zeros(bs, dtype=torch.bool, device=device),
    )


def episode_reset_carry(carry: RewardCarry) -> RewardCarry:
    """What the reference env's reset() actually resets: previous_ctrl and
    the derivative memory, NOT the frozen ctrl-cost reference."""
    p = carry.previous_ctrl
    return RewardCarry(
        previous_ctrl=joint_centers(p.dtype, p.device, p.shape[:-1]),
        ctrl_cost_ref=carry.ctrl_cost_ref,
        ctrl_cost_ref_set=carry.ctrl_cost_ref_set,
        prev_rewards_to_derive=torch.zeros_like(carry.prev_rewards_to_derive),
        has_prev_derive=torch.zeros_like(carry.has_prev_derive),
    )


def _bcast(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (d,) command vector shaped to broadcast against (d, *lanes); a
    vector that already has lane axes passes through."""
    if c.dim() > 1:
        return c
    return c.reshape(c.shape + (1,) * (like.dim() - 1))


def _dot0(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the first (component) axis."""
    return torch.sum(a * b, dim=0)


def _norm0(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=0)


def exp_dist(x):
    return torch.exp(x) - 1.0


# Below this speed the direction of a velocity vector is numerically
# meaningless; unit()'s Jacobian is zeroed there instead of blowing up as
# 1/|x| (the gradient solvers quadratize the stage cost through unit()).
_UNIT_GRAD_EPS = 1e-6


class _Unit(torch.autograd.Function):
    """x / |x| over the first axis. The forward is the where-guarded form
    (0 at x == 0); the derivative is the true projection Jacobian
    (I - u u^T) / |x| for |x| > _UNIT_GRAD_EPS and zero below, so cost
    quadratization near x == 0 gets 0 instead of ~1e30 entries. The
    Jacobian is symmetric, so the same product serves JVP and VJP, and it
    is written in torch ops, so it differentiates again (the gradient
    solvers take Hessians through it with ``torch.func``)."""

    @staticmethod
    def forward(x):
        n2 = _dot0(x, x)
        nonzero = n2 > 0.0
        n = torch.where(nonzero, torch.sqrt(torch.where(nonzero, n2, 1.0)),
                        0.0)
        return x / torch.clamp_min(n, 1e-30)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,) = inputs
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)

    @staticmethod
    def _jacobian_product(x, g):
        n2 = _dot0(x, x)
        big = n2 > _UNIT_GRAD_EPS * _UNIT_GRAD_EPS
        n = torch.sqrt(torch.where(big, n2, 1.0))
        u = x / n
        jg = (g - u * _dot0(u, g)) / n
        return torch.where(big, jg, torch.zeros_like(jg))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return _Unit._jacobian_product(x, g)

    @staticmethod
    def jvp(ctx, dx):
        (x,) = ctx.saved_tensors
        return _Unit._jacobian_product(x, dx)


def unit(x: torch.Tensor) -> torch.Tensor:
    """x / |x| over the first axis, guarded to 0 at x == 0 (the reference
    divides by the raw norm and yields NaN there)."""
    return _Unit.apply(x)


# --- primitives (all take the sensordata of the *current* obs) ---


def ideal_position_cost(sens, sl: SensorSlices, ideal_position):
    cur = sens[sl.pos: sl.pos + 2]
    return _norm0(cur - ideal_position[:2])


def progress_direction_reward_global(sens, sl: SensorSlices, cmd: Command):
    v = sens[sl.linvel: sl.linvel + 2]
    return _dot0(unit(v), _bcast(unit(cmd.velocity[:2]), v))


def progress_speed_cost_global(sens, sl: SensorSlices, cmd: Command):
    d = _norm0(sens[sl.linvel: sl.linvel + 2]) - _norm0(cmd.velocity[:2])
    return torch.square(d)


def progress_direction_reward_local(sens, sl: SensorSlices, cmd: Command):
    v = sens[sl.vel: sl.vel + 2]
    return _dot0(unit(v), _bcast(unit(cmd.velocity[:2]), v))


def progress_speed_reward_local(sens, sl: SensorSlices, cmd: Command):
    """Effective (second) definition of the reference."""
    actual = _norm0(sens[sl.vel: sl.vel + 2])
    inp = _norm0(cmd.velocity[:2])
    return actual - torch.square(inp - actual)


def progress_speed_cost_local(sens, sl: SensorSlices, cmd: Command):
    v = sens[sl.vel: sl.vel + 2]
    d = _norm0(v) - _norm0(cmd.velocity[:2])
    return torch.square(d)


def progress_cost_local(sens, sl: SensorSlices, cmd: Command):
    v = sens[sl.vel: sl.vel + 2]
    d = v - _bcast(cmd.velocity[:2], v)
    return torch.sum(torch.square(d), dim=0)


def heading_reward(sens, sl: SensorSlices, cmd: Command):
    x = sens[sl.xaxis: sl.xaxis + 2]
    return _dot0(x, _bcast(cmd.heading[:2], x))


def orientation_reward(sens, sl: SensorSlices):
    return sens[sl.zaxis + 2]


def body_height_cost(sens, sl: SensorSlices, height=0.12):
    return torch.abs(sens[sl.pos + 2] - height)


def joint_posture_cost(ctrl, nu=12):
    centers = torch.as_tensor(JOINT_CENTERS, dtype=ctrl.dtype,
                              device=ctrl.device)
    return _norm0((ctrl - _bcast(centers, ctrl)) / nu)


def control_cost(ctrl, carry: RewardCarry, alpha=0.8):
    """EMA-smoothed squared control delta with the frozen-reference quirk.
    ``carry.previous_ctrl`` is component-first here, like ``ctrl``.
    Returns (cost, new previous_ctrl, reference)."""
    diff = ctrl - carry.previous_ctrl
    cost = torch.sum(torch.square(diff), dim=0)
    ref = torch.where(carry.ctrl_cost_ref_set, carry.ctrl_cost_ref, cost)
    out = alpha * ref + (1 - alpha) * cost
    return out, ctrl, ref


def _target(values, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(np.array(list(values) * 4), dtype=like.dtype,
                        device=like.device)
    return _bcast(t, like)


def control_frequency_cost(f_est, nu=12, target=(1.0, 1.0, 0.0)):
    return _norm0((f_est - _target(target, f_est)) / nu)


def control_amplitude_cost(a_est, nu=12, target=(1.5, 0.5, 0.0)):
    return _norm0((a_est - _target(target, a_est)) / nu)


def alive_bonus(dtype=torch.float32, device=None):
    return torch.ones((), dtype=dtype, device=device)


# --- terminations ---


def flip_termination(sens, sl: SensorSlices):
    """Body z-axis pointing down."""
    return sens[sl.zaxis + 2] < 0


def time_termination(time, max_time):
    return time >= max_time


# --- the composite ---


class RewardOutput(NamedTuple):
    total: torch.Tensor  # (...,)
    components: torch.Tensor  # (..., 11) ordered as REWARD_KEYS
    carry: RewardCarry


def _first(x: torch.Tensor) -> torch.Tensor:
    """Component axis last -> first."""
    return x.movedim(-1, 0)


def _carry_first(carry: RewardCarry) -> RewardCarry:
    return carry._replace(
        previous_ctrl=_first(carry.previous_ctrl),
        prev_rewards_to_derive=_first(carry.prev_rewards_to_derive))


def input_control_reward(
    sens: torch.Tensor,  # (..., 33)
    ctrl: torch.Tensor,  # (..., 12)
    cmd: Command,  # fields (..., 3)
    ideal_position: torch.Tensor,  # (..., 3)
    f_est: torch.Tensor,  # (..., 12)
    a_est: torch.Tensor,  # (..., 12)
    carry: RewardCarry,
    sl: SensorSlices,
    control_dt: float,
) -> RewardOutput:
    sens, ctrl, ideal = _first(sens), _first(ctrl), _first(ideal_position)
    cmd = Command(*(_first(x) for x in cmd))
    cf = _carry_first(carry)
    cc, new_prev_ctrl, cc_ref = control_cost(ctrl, cf)

    value_rewards = torch.stack([
        +10.0 * alive_bonus(sens.dtype, sens.device).expand(cc.shape),
        -2.0 * cc,
        +10.0 * progress_direction_reward_local(sens, sl, cmd),
        -50.0 * progress_speed_cost_local(sens, sl, cmd),
        +10.0 * exp_dist(heading_reward(sens, sl, cmd)),
        +10.0 * exp_dist(orientation_reward(sens, sl)),
        -50.0 * exp_dist(body_height_cost(sens, sl, 0.13)),
        -1.0 * joint_posture_cost(ctrl),
        -2.5 * control_amplitude_cost(_first(a_est)),
        -8.0 * control_frequency_cost(_first(f_est)),
    ])

    to_derive = torch.stack(
        [-20.0 * ideal_position_cost(sens, sl, ideal)])
    prev = torch.where(cf.has_prev_derive, cf.prev_rewards_to_derive,
                       to_derive)
    derived = (to_derive - prev) / control_dt

    components = torch.cat([value_rewards, derived])  # (11, ...)
    total = torch.sum(components, dim=0)

    new_carry = RewardCarry(
        previous_ctrl=new_prev_ctrl.movedim(0, -1),
        ctrl_cost_ref=cc_ref,
        ctrl_cost_ref_set=torch.ones_like(carry.ctrl_cost_ref_set),
        prev_rewards_to_derive=to_derive.movedim(0, -1),
        has_prev_derive=torch.ones_like(carry.has_prev_derive),
    )
    return RewardOutput(total=total, components=components.movedim(0, -1),
                        carry=new_carry)


# --- dummy task rewards (dead code in the reference due to a broken
# import, reproduced for capability parity) ---


def dummy_forward_reward(sens, sl: SensorSlices):
    return sens[sl.linvel] * sens[sl.pos]


def dummy_no_drift_reward(sens, sl: SensorSlices):
    return torch.abs(sens[sl.linvel + 1] * sens[sl.pos + 1])


def dummy_composite(sens, ctrl, carry: RewardCarry, sl: SensorSlices):
    """``sens`` (..., 33) and ``ctrl`` (..., 12), component axis last."""
    sens, ctrl = _first(sens), _first(ctrl)
    cc, new_prev, cc_ref = control_cost(ctrl, _carry_first(carry))
    total = (
        0.1 * alive_bonus(sens.dtype, sens.device)
        - 0.5 * cc
        + 5.0 * dummy_forward_reward(sens, sl)
        - 3.0 * dummy_no_drift_reward(sens, sl)
    )
    return total, RewardCarry(
        previous_ctrl=new_prev.movedim(0, -1),
        ctrl_cost_ref=cc_ref,
        ctrl_cost_ref_set=torch.ones_like(carry.ctrl_cost_ref_set),
        prev_rewards_to_derive=carry.prev_rewards_to_derive,
        has_prev_derive=carry.has_prev_derive,
    )
