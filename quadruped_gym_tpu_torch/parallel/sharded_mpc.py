"""Sampling MPC with the sample axis spread over the ranks of a mesh.

Counterpart of ``quadruped_gym_tpu/parallel/sharded_mpc.py``: each rank
rolls out ``S/n`` control samples on its own card (no communication) and
the MPPI statistics are reduced across ranks with ``torch.distributed``
collectives on the mesh axis's group:

- ``all_reduce(MIN)`` for the cost baseline (JAX's ``pmin``),
- ``all_reduce(SUM)`` for the normalizer, the weighted plan update, the
  mean cost and the weights' entropy (JAX's ``psum``).

Every function runs on each rank and takes and returns the rank's local
tensors, as a ``shard_map`` body does. The plan (H, nu) is small, so the
collectives move little next to the rollouts.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from ..models.spec import PhysicsModel
from ..physics.engine import State
from ..solvers import mppi as mppi_mod
from ..solvers import rollout as rollout_mod
from ..tasks.commands import Command
from .mesh import DATA_AXIS, SAMPLE_AXIS, axis_size, fold_in

_SUM, _MIN = dist.ReduceOp.SUM, dist.ReduceOp.MIN


def _split(n: int, ndev: int, what: str, axis: str) -> int:
    if n % ndev:
        raise ValueError(f"{what}={n} not divisible by mesh axis '{axis}' "
                         f"size {ndev}")
    return n // ndev


def _mppi_iteration(m, cfg, cost_fn, state, mean, cmd, prev, gen, s_local,
                    group, lo, hi):
    """One MPPI iteration over the group's samples: this rank draws and
    scores ``s_local`` of them. Returns (new_mean, cmin, sum of costs,
    entropy), each the same on every rank of the group."""
    H, nu = mean.shape
    eps = cfg.sigma * torch.randn((s_local, H, nu), generator=gen,
                                  dtype=mean.dtype, device=mean.device)
    seqs = torch.clamp(mean[None] + eps, lo, hi)
    costs = mppi_mod._rollout_costs(m, cfg, cost_fn, state, seqs, cmd, prev)
    costs = torch.where(torch.isfinite(costs), costs, torch.inf)
    cmin = torch.min(costs).reshape(1)
    dist.all_reduce(cmin, _MIN, group=group)  # the global baseline
    cmin = cmin[0]
    unnorm = torch.exp(-(costs - cmin) / cfg.temperature)
    sums = torch.stack([torch.sum(unnorm), torch.sum(costs)])
    dist.all_reduce(sums, _SUM, group=group)  # normalizer, total cost
    w = unnorm / sums[0]
    local = torch.cat([
        torch.einsum("s,shu->hu", w, seqs).reshape(-1),
        -torch.sum(w * torch.log(w + 1e-30))[None],
    ])
    dist.all_reduce(local, _SUM, group=group)  # plan, entropy
    return local[:-1].reshape(H, nu).to(mean.dtype), cmin, sums[1], local[-1]


def sharded_mppi_plan(
    m: PhysicsModel,
    cfg: mppi_mod.MPPIConfig,
    cost_fn: rollout_mod.CostFn,
    state: State,
    mean: torch.Tensor,  # (H, nu) replicated
    cmd: Command,
    prev_ctrl: torch.Tensor,  # (nu,)
    generator: torch.Generator,  # replicated: the same state on every rank
    mesh,
    axis: str = SAMPLE_AXIS,
) -> mppi_mod.PlanResult:
    """MPPI solve with ``cfg.num_samples`` split across ``mesh[axis]``.

    The same as ``mppi.plan`` up to the random stream: each rank draws its
    perturbations from ``fold_in(generator, its index on the axis)``, and
    the softmax is an ``exp`` over a SUM all-reduce. All inputs are
    replicated and so is the result."""
    ndev = axis_size(mesh, axis)
    s_local = _split(cfg.num_samples, ndev, "num_samples", axis)
    group = mesh.get_group(axis)
    gen = fold_in(generator, mesh.get_local_rank(axis))
    lo, hi = mppi_mod._ctrl_bounds(m, mean.dtype, mean.device)
    for _ in range(cfg.iterations):
        mean, cmin, total, ent = _mppi_iteration(
            m, cfg, cost_fn, state, mean, cmd, prev_ctrl, gen, s_local,
            group, lo, hi)
    return mppi_mod.PlanResult(mean=mean, best_cost=cmin,
                               mean_cost=total / cfg.num_samples,
                               weights_entropy=ent)


def sharded_batch_mppi_plan(
    m: PhysicsModel,
    cfg: mppi_mod.MPPIConfig,
    cost_fn: rollout_mod.CostFn,
    states: State,  # (B_local, ...): this rank's scenarios
    means: torch.Tensor,  # (B_local, H, nu)
    cmds: Command,  # (B_local, ...)
    prev_ctrls: torch.Tensor,  # (B_local, nu)
    generator: torch.Generator,  # replicated
    mesh,
    data_axis: str = DATA_AXIS,
    sample_axis: str = SAMPLE_AXIS,
):
    """Scenarios x samples over a 2D mesh: the scenario batch B is cut
    over ``data_axis`` (each rank passes its B/ndata scenarios) and each
    scenario's samples over ``sample_axis``, whose group alone reduces.

    The stream is ``fold_in(fold_in(generator, data index), sample
    index)``, then one ``fold_in`` per local scenario (JAX's split), whose
    iterations draw in turn. Returns (ctrl (B_local, nu), the shifted mean
    (B_local, H, nu), best cost (B_local,)) for this rank's scenarios."""
    nsample = axis_size(mesh, sample_axis)
    s_local = _split(cfg.num_samples, nsample, "num_samples", sample_axis)
    group = mesh.get_group(sample_axis)
    gen = fold_in(fold_in(generator, mesh.get_local_rank(data_axis)),
                  mesh.get_local_rank(sample_axis))
    lo, hi = mppi_mod._ctrl_bounds(m, means.dtype, means.device)
    ctrls, shifted, best = [], [], []
    for b in range(means.shape[0]):
        g_b = fold_in(gen, b)
        state = State(*(x[b] for x in states))
        cmd = Command(*(x[b] for x in cmds))
        mean = means[b]
        for _ in range(cfg.iterations):
            mean, cmin, _, _ = _mppi_iteration(
                m, cfg, cost_fn, state, mean, cmd, prev_ctrls[b], g_b,
                s_local, group, lo, hi)
        ctrls.append(mean[0])
        shifted.append(torch.cat([mean[1:], mean[-1:]], dim=0))
        best.append(cmin)
    return torch.stack(ctrls), torch.stack(shifted), torch.stack(best)


class ShardedBatchResult(NamedTuple):
    costs: torch.Tensor  # (S/n,): this rank's slice of the sample axis


def sharded_rollout_costs(
    m: PhysicsModel,
    cfg: rollout_mod.RolloutConfig,
    cost_fn: rollout_mod.CostFn,
    state: State,
    ctrl_seqs: torch.Tensor,  # (S/n, H, nu): this rank's slice
    cmd: Command,
    prev_ctrl: torch.Tensor,
    mesh,
    axis: str = SAMPLE_AXIS,
) -> torch.Tensor:
    """This rank's (S/n,) rollout costs: pure data parallelism, no
    collective. The costs stay cut over the axis, as the controls were;
    the reduction happens elsewhere."""
    del mesh, axis  # the slice is the caller's: nothing crosses ranks
    return rollout_mod.batched_rollout_cost(m, cfg, cost_fn, state,
                                            ctrl_seqs, cmd, prev_ctrl)
