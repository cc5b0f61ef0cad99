"""Faults planted under a multi-rank cell's run, each a function that
takes a ``setattr`` and patches the port with it: in ranks 1 to N-1 the
harness calls it (``run_cell``'s ``plant``), in rank 0 the test does."""

import torch
import torch.distributed as dist

from quadruped_gym_tpu_torch import parallel
from quadruped_gym_tpu_torch.ops import cuda_engine
from quadruped_gym_tpu_torch.parallel import sharded_mpc


def no_fold_in(set_):
    """Every rank draws the replicated generator's own stream."""
    set_(sharded_mpc, "fold_in", lambda generator, idx: generator)


class _NoPlanSum:
    """``torch.distributed`` without the SUM all-reduce of the plan and
    the entropy (the one tensor longer than two): each rank keeps its own
    weighted sum."""

    def __getattr__(self, name):
        return getattr(dist, name)

    @staticmethod
    def all_reduce(t, op=dist.ReduceOp.SUM, group=None):
        if t.numel() > 2:
            return None
        return dist.all_reduce(t, op, group=group)


def no_plan_sum(set_):
    set_(sharded_mpc, "dist", _NoPlanSum())


def state_unchanged(set_):
    """The solve returns the plan it started from."""
    orig = parallel.sharded_mppi_plan

    def plan(m, cfg, cost_fn, state, mean, *args, **kw):
        res = orig(m, cfg, cost_fn, state, mean, *args, **kw)
        return res._replace(mean=mean)
    set_(parallel, "sharded_mppi_plan", plan)


def half_batch(set_):
    """Each rank draws and weighs half of its share; the mean cost is
    still taken over the whole count."""
    set_(sharded_mpc, "_split", lambda n, ndev, what, axis: n // ndev // 2)


def ctrl_altered(set_):
    """The applied control moved by 0.02 where the plan is produced."""
    orig = parallel.sharded_mppi_plan

    def plan(*args, **kw):
        res = orig(*args, **kw)
        bump = torch.zeros_like(res.mean)
        bump[0, 0] = 0.02
        return res._replace(mean=res.mean + bump)
    set_(parallel, "sharded_mppi_plan", plan)


def costs_altered(set_):
    """Every rollout cost 1 % high where the kernel produces it."""
    orig = cuda_engine.fused_rollout_cost
    set_(cuda_engine, "fused_rollout_cost",
         lambda *args, **kw: orig(*args, **kw) * 1.01)


def raise_in_setup_on_rank_1(set_):
    """Rank 1 raises in its driver's set-up, after joining the group."""
    orig = parallel.make_mesh

    def make_mesh(*args, **kw):
        if dist.get_rank() == 1:
            raise RuntimeError("planted: rank 1 fails in its set-up")
        return orig(*args, **kw)
    set_(parallel, "make_mesh", make_mesh)


FAULTS = ("no_fold_in", "no_plan_sum", "state_unchanged", "half_batch",
          "ctrl_altered", "costs_altered")
