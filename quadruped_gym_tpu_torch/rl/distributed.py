"""Data-parallel PPO across the ranks of a mesh.

Counterpart of ``quadruped_gym_tpu/rl/distributed.py``. The env batch is
cut over the mesh's ``data`` axis: each rank rolls out and learns from
its own slice of the envs, and the only traffic between ranks is one
gradient mean per minibatch (a SUM all-reduce of one flat buffer, then a
division) and the metrics' mean per update. GAE, the advantage
normalization and the epoch permutation are each rank's own, the usual
practice of sharded PPO.

Every rank holds the network, the optimizer and the generator whole
(replicated: the same values on every rank) and its slice of the env
state and observations. The generator advances the same way on every
rank; each update draws from ``fold_in(generator, rank on the axis)``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from ..models.spec import PhysicsModel
from ..parallel.mesh import DATA_AXIS, axis_size, fold_in
from ..runtime import checkpoint
from ..tasks import walking
from . import ppo


def _map(fn, tree):
    """``fn`` on every tensor of a (nested) NamedTuple."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map(fn, x) for x in tree))


def _local_envs(cfg: ppo.PPOConfig, mesh, axis: str) -> int:
    ndata = axis_size(mesh, axis)
    if cfg.num_envs % ndata:
        raise ValueError(f"num_envs={cfg.num_envs} not divisible by data "
                         f"axis {ndata}")
    return cfg.num_envs // ndata


def make_distributed_update(m: PhysicsModel, env_cfg: walking.WalkingConfig,
                            cfg: ppo.PPOConfig, mesh, axis: str = DATA_AXIS):
    """One sharded PPO update: TrainState -> (TrainState, UpdateMetrics),
    run on every rank with its local TrainState.

    ``cfg.num_envs`` is the GLOBAL env count; it must divide by the data
    axis size. The metrics come back averaged over the ranks."""
    n_local = _local_envs(cfg, mesh, axis)
    ndata = axis_size(mesh, axis)
    local_cfg = dataclasses.replace(cfg, num_envs=n_local)
    update = ppo.update_fn(m, env_cfg, local_cfg, axis_name=axis, mesh=mesh)
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)

    def sharded(ts: ppo.TrainState):
        # the rank's stream is re-derived from the replicated generator at
        # each update; the generator itself goes on the same on every rank
        new_ts, metrics = update(ts._replace(
            generator=fold_in(ts.generator, idx)))
        flat = torch.cat([x.reshape(-1) for x in metrics])
        dist.all_reduce(flat, dist.ReduceOp.SUM, group=group)
        flat = flat / ndata
        parts = torch.split(flat, [x.numel() for x in metrics])
        metrics = ppo.UpdateMetrics(*(p.reshape(x.shape).to(x.dtype)
                                      for p, x in zip(parts, metrics)))
        return new_ts._replace(generator=ts.generator), metrics

    return sharded


def local_slice(ts: ppo.TrainState, mesh,
                axis: str = DATA_AXIS) -> ppo.TrainState:
    """This rank's TrainState from a global one: its contiguous slice of
    the envs, the rest as it is."""
    n = ts.obs.shape[0] // axis_size(mesh, axis)
    r = mesh.get_local_rank(axis)

    def cut(x):
        return x[r * n:(r + 1) * n].contiguous()

    return ts._replace(env_state=_map(cut, ts.env_state), obs=cut(ts.obs))


def gather(ts: ppo.TrainState, mesh,
           axis: str = DATA_AXIS) -> ppo.TrainState:
    """The global TrainState on every rank: each env leaf all-gathered
    over the axis in rank order (a collective: every rank calls it)."""
    group = mesh.get_group(axis)
    n = axis_size(mesh, axis)

    def whole(x: torch.Tensor) -> torch.Tensor:
        send = (x.to(torch.uint8) if x.dtype == torch.bool else x)
        parts = [torch.empty_like(send) for _ in range(n)]
        dist.all_gather(parts, send.contiguous(), group=group)
        return torch.cat(parts).to(x.dtype)

    return ts._replace(env_state=_map(whole, ts.env_state),
                       obs=whole(ts.obs))


def init_distributed_train_state(m: PhysicsModel,
                                 env_cfg: walking.WalkingConfig,
                                 cfg: ppo.PPOConfig, seed: int, mesh,
                                 axis: str = DATA_AXIS,
                                 device=None) -> ppo.TrainState:
    """Every rank builds the global initial state from one seed (the same
    network, the same reset of all ``cfg.num_envs`` envs) and keeps its
    slice of the env state and observations."""
    _local_envs(cfg, mesh, axis)
    ts = ppo.init_train_state(m, env_cfg, cfg, seed, device=device)
    return local_slice(ts, mesh, axis)


def restore(path: str, ts: ppo.TrainState, mesh,
            axis: str = DATA_AXIS) -> Tuple[ppo.TrainState, int]:
    """(local TrainState, step) from a checkpoint of the global state, as
    ``runtime.checkpoint.save`` wrote it: each rank reads it whole and
    keeps its slice."""
    restored, step = checkpoint.restore(path, gather(ts, mesh, axis))
    return local_slice(restored, mesh, axis), step
