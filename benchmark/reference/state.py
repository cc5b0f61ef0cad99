# Frozen copy of ``State`` and ``make_state`` from
# quadruped_gym_tpu_torch/physics/engine.py for the benchmark's plain reference.
"""The physics state of a batch of robots, leading batch axes."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ._device import resolve_device
from .spec import PhysicsModel


class State(NamedTuple):
    qpos: torch.Tensor  # (..., nq)
    qvel: torch.Tensor  # (..., nv)
    act: torch.Tensor  # (..., na)
    time: torch.Tensor  # (...)
    sensordata: torch.Tensor  # (..., nsensordata) reading at the last forward()


def make_state(m: PhysicsModel, dtype=torch.float32, device=None) -> State:
    """Default state: qpos0, zero velocity/activation (mj_resetData)."""
    device = resolve_device(device)
    return State(
        qpos=torch.as_tensor(np.asarray(m.qpos0), dtype=dtype, device=device),
        qvel=torch.zeros(m.nv, dtype=dtype, device=device),
        act=torch.zeros(m.na, dtype=dtype, device=device),
        time=torch.zeros((), dtype=dtype, device=device),
        sensordata=torch.zeros(m.nsensordata, dtype=dtype, device=device),
    )
