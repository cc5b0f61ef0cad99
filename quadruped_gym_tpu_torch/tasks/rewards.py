"""The stateless reward primitives the walking stage cost needs.

Counterpart of part of ``quadruped_gym_tpu/tasks/rewards.py``. Every
function takes sensordata whose FIRST axis is the sensor axis, so one
sample (33,) and a lane batch (33, B) go through the same code; command
vectors are (3,) and broadcast over the lanes. ``unit`` is forward only:
its custom gradient waits for the gradient solvers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.spec import PhysicsModel
from .commands import Command

JOINT_CENTERS = np.array([0.0, 0.0, -0.5] * 4, dtype=np.float64)


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


def _bcast(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (d,) command vector shaped to broadcast against (d, *lanes)."""
    return c.reshape(c.shape + (1,) * (like.dim() - 1))


def _dot0(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the first (component) axis."""
    return torch.sum(a * b, dim=0)


def exp_dist(x):
    return torch.exp(x) - 1.0


def unit(x: torch.Tensor) -> torch.Tensor:
    """x / |x| over the first axis, guarded to 0 at x == 0."""
    n2 = _dot0(x, x)
    nonzero = n2 > 0.0
    n = torch.where(nonzero, torch.sqrt(torch.where(nonzero, n2, 1.0)), 0.0)
    return x / torch.clamp_min(n, 1e-30)


def progress_direction_reward_local(sens, sl: SensorSlices, cmd: Command):
    v = sens[sl.vel: sl.vel + 2]
    return _dot0(unit(v), _bcast(unit(cmd.velocity[:2]), v))


def progress_speed_cost_local(sens, sl: SensorSlices, cmd: Command):
    v = sens[sl.vel: sl.vel + 2]
    d = torch.linalg.vector_norm(v, dim=0) - torch.linalg.vector_norm(
        cmd.velocity[:2])
    return torch.square(d)


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
    return torch.linalg.vector_norm((ctrl - _bcast(centers, ctrl)) / nu, dim=0)


def alive_bonus(dtype=torch.float32, device=None):
    return torch.ones((), dtype=dtype, device=device)
