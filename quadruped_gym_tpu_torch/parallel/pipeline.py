"""Pipeline parallelism over the MPC horizon (GPipe over a ``stage`` axis).

Counterpart of ``quadruped_gym_tpu/parallel/pipeline.py``. The H control
steps of a rollout are cut into ``n_stages`` contiguous segments, one per
rank of the ``stage`` axis. The samples are cut into M microbatches that
flow through the pipe: at tick t stage s integrates microbatch t - s over
its segment on the oracle engine, then hands the boundary (state,
prev_ctrl) to stage s + 1 as one packed buffer (JAX's ``ppermute``: a
matched send and receive). After the (n_stages - 1)-tick fill every stage
works on a different microbatch; M + n_stages - 1 ticks in all, GPipe's
bubble (n_stages - 1) / (M + n_stages - 1).

Numerics: each microbatch's trajectory visits the same physics steps in
the same order as ``solvers.rollout.batched_rollout_cost``; only the cost
sum regroups (per-segment partial sums, one SUM all-reduce across the
stages), so the costs match it to reduction-order rounding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..models.spec import PhysicsModel
from ..physics import engine
from ..solvers import rollout as rollout_mod
from ..tasks.commands import Command
from .mesh import axis_size

STAGE_AXIS = "stage"


def _pack(st: engine.State, prev: torch.Tensor) -> torch.Tensor:
    """The boundary carry of a microbatch as one contiguous (mb, k)
    buffer: qpos, qvel, act, time, sensordata, prev_ctrl."""
    return torch.cat([st.qpos, st.qvel, st.act, st.time[:, None],
                      st.sensordata, prev], dim=1).contiguous()


def _unpack(buf: torch.Tensor, like: engine.State):
    """(State, prev_ctrl) of a buffer ``_pack`` made from states shaped
    like ``like``."""
    sizes = [like.qpos.shape[1], like.qvel.shape[1], like.act.shape[1], 1,
             like.sensordata.shape[1]]
    parts = list(torch.split(buf, sizes + [buf.shape[1] - sum(sizes)],
                             dim=1))
    parts[3] = parts[3][:, 0]  # time
    return engine.State(*parts[:5]), parts[5]


def pipelined_rollout_cost(
    m: PhysicsModel,
    cfg: rollout_mod.RolloutConfig,
    cost_fn: rollout_mod.CostFn,
    state0: engine.State,
    ctrl_seqs: torch.Tensor,  # (S, H, nu), the same on every stage
    cmd: Command,
    prev_ctrl0: torch.Tensor,  # (nu,)
    mesh,
    stage_axis: str = STAGE_AXIS,
    num_microbatches: Optional[int] = None,
) -> torch.Tensor:
    """(S,) rollout costs with the horizon pipelined across
    ``mesh[stage_axis]``, replicated on every stage.

    Semantics match ``rollout.batched_rollout_cost`` (one shared start
    state, per-step stage costs, prev_ctrl carried across steps, also
    across a segment boundary, where it rides the hand-off).
    ``num_microbatches`` (default: n_stages) sets the bubble: more
    microbatches amortize the (n_stages - 1)-tick fill and drain."""
    S, H, nu = ctrl_seqs.shape
    n_stages = axis_size(mesh, stage_axis)
    if H % n_stages:
        raise ValueError(f"horizon {H} not divisible by {n_stages} stages")
    seg = H // n_stages
    M = num_microbatches or n_stages
    if S % M:
        raise ValueError(f"batch {S} not divisible by {M} microbatches")
    mb = S // M
    s = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    ranks = dist.get_process_group_ranks(group)
    # this stage's segment of every microbatch: (M, mb, seg, nu)
    seqs = ctrl_seqs[:, s * seg:(s + 1) * seg].reshape(M, mb, seg, nu)
    fresh = engine.State(*(x.expand((mb,) + x.shape) for x in state0))
    fresh_prev = prev_ctrl0.expand(mb, nu)
    carry_len = _pack(fresh, fresh_prev).shape[1]
    cost_acc = ctrl_seqs.new_zeros(M, mb)

    def exchange(out: Optional[torch.Tensor], take: bool):
        """Send ``out`` to the next stage and/or take the next boundary
        from the previous one, as one batch of matched point-to-point
        operations (JAX's ``ppermute``)."""
        inbox = ctrl_seqs.new_empty(mb, carry_len) if take else None
        ops = []
        if out is not None:
            ops.append(dist.P2POp(dist.isend, out, ranks[s + 1], group))
        if take:
            ops.append(dist.P2POp(dist.irecv, inbox, ranks[s - 1], group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return inbox

    if n_stages > 1:
        # NCCL wants every rank of the group in its first collective; the
        # point-to-point batches below each hold two ranks at most
        dist.barrier(group=group)
    # stage s holds microbatch k at tick s + k: idle for the first s ticks
    # (the fill) and the last n_stages - 1 - s (the drain)
    inbox = exchange(None, s > 0)
    for k in range(M):
        if s == 0:
            st, prev = fresh, fresh_prev
        else:
            st, prev = _unpack(inbox, fresh)
        for j in range(seg):
            u = seqs[k, :, j]
            st = engine.control_step(
                m, st, u, cfg.frame_skip, max_contacts=cfg.max_contacts,
                solver_iterations=cfg.solver_iterations)
            cost_acc[k] += cost_fn(st.sensordata.movedim(-1, 0),
                                   u.movedim(-1, 0), prev.movedim(-1, 0),
                                   cmd)
            prev = u
        # the boundary goes to stage s + 1, which holds this microbatch at
        # the next tick; the next microbatch's comes in from stage s - 1
        inbox = exchange(_pack(st, prev) if s + 1 < n_stages else None,
                         s > 0 and k + 1 < M)
    dist.all_reduce(cost_acc, dist.ReduceOp.SUM, group=group)
    return cost_acc.reshape(S)


def pipelined_mppi_plan(
    m: PhysicsModel,
    cfg,
    cost_fn: rollout_mod.CostFn,
    state0: engine.State,
    mean: torch.Tensor,  # (H, nu)
    cmd: Command,
    prev_ctrl0: torch.Tensor,
    generator: torch.Generator,  # replicated: every stage draws the same
    mesh,
    stage_axis: str = STAGE_AXIS,
    num_microbatches: Optional[int] = None,
):
    """One MPPI update whose rollout scoring runs through the horizon
    pipeline. Returns (ctrl, new_mean, best_cost) like ``mppi.plan``'s
    essentials; sampling and weighting are replicated (they are small
    next to the physics)."""
    S, H = cfg.num_samples, mean.shape[0]
    eps = cfg.sigma * torch.randn((S, H, m.nu), generator=generator,
                                  dtype=mean.dtype, device=mean.device)
    seqs = torch.clamp(mean[None] + eps, -1.0, 1.0)
    costs = pipelined_rollout_cost(
        m, cfg.rollout, cost_fn, state0, seqs, cmd, prev_ctrl0, mesh,
        stage_axis, num_microbatches)
    w = torch.softmax(-(costs - costs.min()) / cfg.temperature, dim=0)
    new_mean = torch.einsum("s,shu->hu", w, seqs)
    return new_mean[0], new_mean, costs.min()
