"""Observation models.

Counterpart of ``quadruped_gym_tpu/tasks/observations.py``. Full
observability is the raw 33-dim sensordata. Partial observability is a
26-dim IMU-centric frame: gyro(3) + accel(3) + Madgwick-estimated Euler
angles(3) + local optical-flow velocity xy(2) + applied ctrl(12) + command
velocity xy(2) + heading angle(1), stacked over ``obs_window`` frames.
Any leading batch axes; the component axis is the last.

Reference semantics preserved: the Madgwick quaternion only integrates
when sim time has passed settling_time/2; at reset the observation is
computed with the *stale* filter state before the filter is re-seeded
from the true base quaternion (``tasks.walking.reset`` does that).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from . import madgwick
from .commands import Command, heading_theta
from .rewards import SensorSlices

PO_OBS_DIM = 26


class PoObsCarry(NamedTuple):
    mad_quat: torch.Tensor  # (..., 4)
    buffer: torch.Tensor  # (..., obs_window, 26)


def po_init_carry(obs_window: int, dtype=torch.float32, device=None,
                  batch_shape=()) -> PoObsCarry:
    device = resolve_device(device)
    bs = tuple(batch_shape)
    q0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
    return PoObsCarry(
        mad_quat=q0.expand(bs + (4,)).clone(),
        buffer=torch.zeros(bs + (obs_window, PO_OBS_DIM), dtype=dtype,
                           device=device))


def po_observation(
    sl: SensorSlices,
    sens: torch.Tensor,  # (..., 33)
    ctrl: torch.Tensor,  # (..., 12)
    cmd: Command,
    mad_quat: torch.Tensor,  # (..., 4)
    time: torch.Tensor,  # (...,)
    settling_time: float,
    control_dt: float,
):
    """Single-frame PO observation. Returns (obs (..., 26), new_mad_quat)."""
    gyro = sens[..., sl.gyro: sl.gyro + 3]
    accel = sens[..., sl.accel: sl.accel + 3]

    q_updated = madgwick.update_imu(mad_quat, gyro, accel, control_dt)
    new_q = torch.where((time > settling_time / 2.0)[..., None], q_updated,
                        mad_quat)

    euler = madgwick.to_euler(new_q)
    obs = torch.cat([
        gyro,
        accel,
        euler,
        sens[..., sl.vel: sl.vel + 2],
        ctrl,
        cmd.velocity[..., :2],
        heading_theta(cmd)[..., None],
    ], dim=-1)
    return obs, new_q


def stack_push(buffer: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Frame-stacking push: drop the oldest frame, append the new one."""
    return torch.cat([buffer[..., 1:, :], obs[..., None, :]], dim=-2)


def stack_fill(buffer: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """Reset-time fill: the whole window is copies of the current obs."""
    return obs[..., None, :].expand(buffer.shape).to(buffer.dtype).clone()
