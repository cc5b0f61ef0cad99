# Frozen copy of quadruped_gym_tpu_torch/tasks/commands.py for the benchmark's plain
# reference: the same code, with its imports pointed at this folder. Later
# changes to the port do not reach it.
"""High-level velocity/heading command.

Counterpart of ``quadruped_gym_tpu/tasks/commands.py``: a local velocity,
a unit heading and the heading-rotated global velocity, plus randomized
sampling with the reference's options (min_speed / max_speed /
fixed_heading_angle / fixed_velocity_angle / fixed_speed). Where the JAX
package vmaps these over environments, the functions here take any
leading batch axes: the component axis is the LAST one, so a single
command is (3,) and a batch of them (B, 3). Random keys become a
``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ._device import resolve_device


class Command(NamedTuple):
    velocity: torch.Tensor  # (..., 3) local [vx, vy, 0]
    heading: torch.Tensor  # (..., 3) unit [cos t, sin t, 0]
    global_velocity: torch.Tensor  # (..., 3) heading-rotated velocity, z = 0


class SampleOptions(NamedTuple):
    """Sampling options. NaN means 'not fixed'."""

    min_speed: float = 0.0
    max_speed: float = 1.0
    fixed_heading_angle: float = float("nan")
    fixed_velocity_angle: float = float("nan")
    fixed_speed: float = float("nan")

    @classmethod
    def from_dict(cls, options: Optional[dict]) -> "SampleOptions":
        options = options or {}

        def g(k, dflt):
            return float(options.get(k, dflt)
                         if options.get(k) is not None else dflt)

        nan = float("nan")
        return cls(
            min_speed=g("min_speed", 0.0),
            max_speed=g("max_speed", 1.0),
            fixed_heading_angle=g("fixed_heading_angle", nan),
            fixed_velocity_angle=g("fixed_velocity_angle", nan),
            fixed_speed=g("fixed_speed", nan),
        )


def _rotate(velocity: torch.Tensor, heading: torch.Tensor) -> torch.Tensor:
    v0, v1 = velocity[..., 0], velocity[..., 1]
    h0, h1 = heading[..., 0], heading[..., 1]
    return torch.stack([h0 * v0 - h1 * v1, h1 * v0 + h0 * v1,
                        torch.zeros_like(v0)], dim=-1)


def make(velocity_xy: torch.Tensor, heading_theta: torch.Tensor) -> Command:
    """Command from a local (..., 2) velocity and a (...,) heading angle
    (on the same device and of the same dtype)."""
    vel = torch.cat([velocity_xy, torch.zeros_like(velocity_xy[..., :1])],
                    dim=-1)
    heading = torch.stack([torch.cos(heading_theta), torch.sin(heading_theta),
                           torch.zeros_like(heading_theta)], dim=-1)
    return Command(velocity=vel, heading=heading,
                   global_velocity=_rotate(vel, heading))


def from_speed_alpha(speed, alpha, heading_theta) -> Command:
    """set_velocity_speed_alpha + set_orientation semantics."""
    vxy = torch.stack([speed * torch.cos(alpha), speed * torch.sin(alpha)],
                      dim=-1)
    return make(vxy, torch.as_tensor(heading_theta, dtype=vxy.dtype,
                                     device=vxy.device))


def zero(dtype=torch.float32, device=None, batch_shape=()) -> Command:
    z3 = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype,
                     device=resolve_device(device))
    return Command(velocity=z3, heading=z3, global_velocity=z3)


def sample(generator: torch.Generator, opts: SampleOptions,
           dtype=torch.float32, batch_shape=()) -> Command:
    """Randomized commands: heading and velocity angles ~ U(-pi, pi),
    speed ~ U(min, max); fixed values override. One command per entry of
    ``batch_shape``, on the generator's device."""
    shape, dev = tuple(batch_shape), generator.device

    def uniform(lo, hi):
        u = torch.rand(shape, generator=generator, dtype=dtype, device=dev)
        return lo + (hi - lo) * u

    def fixed(value, drawn):
        return drawn if math.isnan(value) else torch.full_like(drawn, value)

    theta = fixed(opts.fixed_heading_angle, uniform(-math.pi, math.pi))
    alpha = fixed(opts.fixed_velocity_angle, uniform(-math.pi, math.pi))
    speed = fixed(opts.fixed_speed, uniform(opts.min_speed, opts.max_speed))
    return from_speed_alpha(speed, alpha, theta)


def heading_theta(cmd: Command) -> torch.Tensor:
    return torch.atan2(cmd.heading[..., 1], cmd.heading[..., 0])


def velocity_speed_alpha(cmd: Command):
    speed = torch.linalg.vector_norm(cmd.velocity[..., :2], dim=-1)
    alpha = torch.atan2(cmd.velocity[..., 1], cmd.velocity[..., 0])
    return speed, alpha


def global_velocity_speed_alpha(cmd: Command):
    speed = torch.linalg.vector_norm(cmd.global_velocity[..., :2], dim=-1)
    alpha = torch.atan2(cmd.global_velocity[..., 1],
                        cmd.global_velocity[..., 0])
    return speed, alpha
