"""Vectorized walking environment with auto-reset.

Counterpart of ``quadruped_gym_tpu/envs/vector_env.py``: thousands of
environments on one card; auto-reset keeps the batch dense. Persistent
carries behave as in the reference: the frequency estimator and the
frozen control-cost reference survive episode boundaries.
``autoreset_step`` (``lane_physics=False``) steps the physics on the
oracle engine, ``batched_autoreset_step`` (``lane_physics=True``) through
the batch-minor engines.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device
from ..models.spec import PhysicsModel
from ..tasks import walking
from ..utils import profiling


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


def _autoreset(m, cfg, out: walking.StepOutput, num_envs: int,
               generator: torch.Generator) -> VectorStepOutput:
    """Reset the environments whose step ``out`` ended their episode. As in
    the JAX package, fresh states are drawn for every environment each
    step (from ``generator``) and selected by ``done``; the estimator and
    the frozen control-cost reference survive the reset."""
    with profiling.span("vector_env.autoreset"):
        fresh, fresh_obs = walking.reset(
            m, cfg, num_envs, generator,
            persistent=(out.state.est, out.state.rew))
        done = out.terminated
        return VectorStepOutput(
            state=_select(done, fresh, out.state),
            obs=_select(done, fresh_obs, out.obs),
            reward=out.reward,
            done=done,
            reward_components=out.reward_components,
        )


def autoreset_step(
    m: PhysicsModel, cfg: walking.WalkingConfig, st: walking.WalkingState,
    action: torch.Tensor, generator: torch.Generator,
) -> VectorStepOutput:
    """One step of every environment on the oracle engine
    (``walking.step``) with auto-reset on termination. The returned
    reward/done describe the step that just happened; the state and obs
    are post-reset where the episode ended."""
    out = walking.step(m, cfg, st, action)
    return _autoreset(m, cfg, out, action.shape[0], generator)


def batched_autoreset_step(
    m: PhysicsModel, cfg: walking.WalkingConfig, st: walking.WalkingState,
    action: torch.Tensor, generator: torch.Generator,
    engine_impl: str = "auto",
) -> VectorStepOutput:
    """``autoreset_step`` with the physics through a batch-minor engine
    (see ``walking.batched_step`` for ``engine_impl``): the
    training-throughput path."""
    with profiling.span("vector_env.batched_autoreset_step"):
        out = walking.batched_step(m, cfg, st, action, engine_impl=engine_impl)
        return _autoreset(m, cfg, out, action.shape[0], generator)


class VectorWalkingEnv:
    """Batched auto-resetting environment. It holds the generator that
    draws reset states and commands, on ``device`` (the card unless
    ``device="cpu"``), seeded with ``seed``. ``lane_physics=False`` (the
    default, as in the JAX package) steps on the oracle engine,
    ``lane_physics=True`` through the batch-minor engines."""

    def __init__(self, m: PhysicsModel, cfg: walking.WalkingConfig,
                 num_envs: int, lane_physics: bool = False, seed: int = 0,
                 device=None):
        self.m = m
        self.cfg = cfg
        self.num_envs = num_envs
        self.lane_physics = lane_physics
        self.obs_size = walking.obs_size(cfg, m)
        self.generator = torch.Generator(device=resolve_device(device))
        self.generator.manual_seed(seed)

    def reset(self):
        return walking.reset(self.m, self.cfg, self.num_envs, self.generator)

    def step(self, state, actions: torch.Tensor) -> VectorStepOutput:
        step = batched_autoreset_step if self.lane_physics else autoreset_step
        return step(self.m, self.cfg, state, actions, self.generator)
