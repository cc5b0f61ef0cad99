"""Typed top-level configuration.

Counterpart of ``quadruped_gym_tpu/runtime/config.py``: the per-layer
frozen dataclasses (WalkingConfig, MPPIConfig, CEMConfig, ILQRConfig,
SQPConfig, RolloutConfig, MPCConfig, PPOConfig) compose into one
``FrameworkConfig`` with dict/JSON round-tripping. A dtype is written as
its name (``"float32"``, ``"float64"``), as the JAX package writes it, so
a file saved by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

import torch

from ..rl.ppo import PPOConfig
from ..runtime.mpc_runtime import MPCConfig
from ..solvers.cem import CEMConfig
from ..solvers.ilqr import ILQRConfig
from ..solvers.mppi import MPPIConfig
from ..solvers.rollout import RolloutConfig
from ..solvers.sqp import SQPConfig
from ..tasks.commands import SampleOptions
from ..tasks.walking import WalkingConfig


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh shape; (-1, 1) = all devices on the sample axis."""

    data: int = 1
    sample: int = -1


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    model_path: Optional[str] = None  # None = packaged scene.xml
    collision_geom_prefixes: Optional[tuple] = None
    env: WalkingConfig = WalkingConfig()
    mpc: MPCConfig = MPCConfig()
    ilqr: ILQRConfig = ILQRConfig()
    ppo: PPOConfig = PPOConfig()
    mesh: MeshConfig = MeshConfig()
    seed: int = 0


_NESTED = {
    "env": WalkingConfig,
    "mpc": MPCConfig,
    "ilqr": ILQRConfig,
    "sqp": SQPConfig,
    "ppo": PPOConfig,
    "mesh": MeshConfig,
    "mppi": MPPIConfig,
    "cem": CEMConfig,
    "rollout": RolloutConfig,
    "reset_options": SampleOptions,
}


def _to_dict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {
            f.name: _to_dict(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {k: _to_dict(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (list, tuple)):
        return [_to_dict(v) for v in obj]
    if isinstance(obj, torch.dtype):  # torch.float32 -> "float32"
        return str(obj).removeprefix("torch.")
    return obj


def _from_dict(cls, data: dict):
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in data.items():
        if key not in fields:
            raise KeyError(f"{cls.__name__} has no field '{key}'")
        if isinstance(val, dict) and key in _NESTED:
            sub = _NESTED[key]
            if dataclasses.is_dataclass(sub):
                val = _from_dict(sub, val)
            else:  # NamedTuple configs (SampleOptions)
                val = sub(**val)
        elif isinstance(val, list):
            val = tuple(val)
        if key == "dtype" and isinstance(val, str):
            val = getattr(torch, val)
            if not isinstance(val, torch.dtype):
                raise ValueError(f"{data[key]!r} is not a torch dtype")
        kwargs[key] = val
    return cls(**kwargs)


def to_dict(cfg: FrameworkConfig) -> dict:
    return _to_dict(cfg)


def from_dict(data: dict) -> FrameworkConfig:
    return _from_dict(FrameworkConfig, data)


def save(path: str, cfg: FrameworkConfig) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load(path: str) -> FrameworkConfig:
    with open(path) as f:
        return from_dict(json.load(f))
