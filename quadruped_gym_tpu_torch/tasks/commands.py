"""Velocity/heading command.

Counterpart of ``Command``, ``_rotate`` and ``make`` in
``quadruped_gym_tpu/tasks/commands.py``; command sampling is not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Command(NamedTuple):
    velocity: torch.Tensor  # (3,) local [vx, vy, 0]
    heading: torch.Tensor  # (3,) unit [cos t, sin t, 0]
    global_velocity: torch.Tensor  # (3,) heading-rotated velocity, z = 0


def _rotate(velocity: torch.Tensor, heading: torch.Tensor) -> torch.Tensor:
    v0, v1 = velocity[0], velocity[1]
    h0, h1 = heading[0], heading[1]
    return torch.stack([h0 * v0 - h1 * v1, h1 * v0 + h0 * v1,
                        torch.zeros_like(v0)])


def make(velocity_xy: torch.Tensor, heading_theta: torch.Tensor) -> Command:
    """Command from a local (2,) velocity and a heading angle (a 0-d
    tensor on the same device and of the same dtype)."""
    vel = torch.cat([velocity_xy, torch.zeros_like(velocity_xy[:1])])
    heading = torch.stack([torch.cos(heading_theta), torch.sin(heading_theta),
                           torch.zeros_like(heading_theta)])
    return Command(velocity=vel, heading=heading,
                   global_velocity=_rotate(vel, heading))
