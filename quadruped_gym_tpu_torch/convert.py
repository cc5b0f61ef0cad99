"""Carry values across from the JAX package to this one.

The system has no weights: what crosses between the two packages is state.
Each function takes the JAX package's value as anything that holds numpy
arrays (or numpy-convertible arrays) under the same field names, and
returns the port's counterpart on ``device`` in ``dtype``. The tests feed
both packages through these.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .models.spec import DomainParams
from .ops.lane_engine import LaneState
from .physics.engine import State
from .runtime.mpc_runtime import MPCCarry
from .tasks.commands import Command


def tensor(x, dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype,
                           device=resolve_device(device))


def _fields(cls, src, dtype, device):
    return cls(**{f: tensor(getattr(src, f), dtype, device)
                  for f in cls._fields})


def state(src, dtype=torch.float64, device=None) -> State:
    """``physics.engine.State`` (qpos, qvel, act, time, sensordata)."""
    return _fields(State, src, dtype, device)


def lane_state(src, dtype=torch.float64, device=None) -> LaneState:
    """``ops.lane_engine.LaneState`` (batch-minor)."""
    return _fields(LaneState, src, dtype, device)


def command(src, dtype=torch.float64, device=None) -> Command:
    """``tasks.commands.Command``."""
    return _fields(Command, src, dtype, device)


def domain_params(src, dtype=torch.float64, device=None) -> DomainParams:
    """``models.spec.DomainParams``; None fields stay None."""
    return DomainParams(**{
        f: None if getattr(src, f) is None
        else tensor(getattr(src, f), dtype, device)
        for f in DomainParams._fields
    })


def mpc_carry(src, seed: int, dtype=torch.float64, device=None) -> MPCCarry:
    """``runtime.mpc_runtime.MPCCarry``: mean, sigma and prev_ctrl carry
    over; the JAX key does not (the two frameworks' random streams
    differ), so the port's generator is seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return MPCCarry(mean=tensor(src.mean, dtype, device),
                    sigma=tensor(src.sigma, dtype, device),
                    prev_ctrl=tensor(src.prev_ctrl, dtype, device),
                    generator=gen)
