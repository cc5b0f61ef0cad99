"""Vectorized walking environment with auto-reset.

Counterpart of ``quadruped_gym_tpu/envs/vector_env.py``: thousands of
environments on one card, physics through the batch-minor engines;
auto-reset keeps the batch dense. Persistent carries behave as in the
reference: the frequency estimator and the frozen control-cost reference
survive episode boundaries. The per-sample path (``autoreset_step``,
``lane_physics=False``) runs on the oracle engine, which is not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..models.spec import PhysicsModel
from ..tasks import walking


class VectorStepOutput(NamedTuple):
    state: walking.WalkingState  # leading axis N
    obs: torch.Tensor  # (N, obs_dim)
    reward: torch.Tensor  # (N,)
    done: torch.Tensor  # (N,) bool
    reward_components: torch.Tensor  # (N, 11)


def _select(done: torch.Tensor, fresh, old):
    """Per leaf: ``fresh`` where the env is done, else ``old``; the (N,)
    mask is reshaped to each leaf's rank."""
    if isinstance(fresh, torch.Tensor):
        mask = done.reshape(done.shape + (1,) * (fresh.dim() - 1))
        return torch.where(mask, fresh, old)
    return type(fresh)(*(_select(done, a, b) for a, b in zip(fresh, old)))


def batched_autoreset_step(
    m: PhysicsModel, cfg: walking.WalkingConfig, st: walking.WalkingState,
    action: torch.Tensor, generator: torch.Generator,
    engine_impl: str = "auto",
) -> VectorStepOutput:
    """One step of every environment with auto-reset on termination (see
    ``walking.batched_step`` for ``engine_impl``). The returned
    reward/done describe the step that just happened; the state and obs
    are post-reset where the episode ended. As in the JAX package, fresh
    states are drawn for every environment each step (from ``generator``)
    and selected by ``done``; the estimator and the frozen control-cost
    reference survive the reset."""
    out = walking.batched_step(m, cfg, st, action, engine_impl=engine_impl)
    fresh, fresh_obs = walking.reset(
        m, cfg, action.shape[0], generator,
        persistent=(out.state.est, out.state.rew))
    done = out.terminated
    return VectorStepOutput(
        state=_select(done, fresh, out.state),
        obs=_select(done, fresh_obs, out.obs),
        reward=out.reward,
        done=done,
        reward_components=out.reward_components,
    )


class VectorWalkingEnv:
    """Batched auto-resetting environment. It holds the generator that
    draws reset states and commands, on ``device`` (the card unless
    ``device="cpu"``), seeded with ``seed``."""

    def __init__(self, m: PhysicsModel, cfg: walking.WalkingConfig,
                 num_envs: int, lane_physics: bool = True, seed: int = 0,
                 device=None):
        if not lane_physics:
            raise NotImplementedError(
                "lane_physics=False steps each environment on the oracle "
                "engine, which is not ported yet (ROADMAP.md A.8)")
        self.m = m
        self.cfg = cfg
        self.num_envs = num_envs
        self.obs_size = walking.obs_size(cfg, m)
        self.generator = torch.Generator(device=resolve_device(device))
        self.generator.manual_seed(seed)

    def reset(self):
        return walking.reset(self.m, self.cfg, self.num_envs, self.generator)

    def step(self, state, actions: torch.Tensor) -> VectorStepOutput:
        return batched_autoreset_step(self.m, self.cfg, state, actions,
                                      self.generator)
