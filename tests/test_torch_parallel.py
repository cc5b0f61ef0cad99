"""The port's sharded MPC (``parallel/``) over 2 and 4 gloo ranks on the
CPU, float64, held to its unsharded counterparts: the counterpart of the
JAX package's ``tests/test_parallel.py`` and of parts 1-3 of
``__graft_entry__.dryrun_multichip``.

- ``sharded_rollout_costs``: each rank's slice equals
  ``batched_rollout_cost`` on it (1e-12).
- ``sharded_mppi_plan`` (the oracle engine, and the fused route, whose
  plain version a CPU tensor gets): equal to ``mppi.weighted_update`` over
  the concatenation of the ranks' draws, rebuilt here from ``fold_in``,
  over 2 iterations (1e-12: the softmax is an exp over a SUM all-reduce).
- ``sharded_batch_mppi_plan`` on a (data, sample) mesh of (1, 2) and
  (2, 2) ranks: equal to the fold structure rebuilt scenario by scenario.
- What is replicated is equal in every bit on every rank.

On a world-1 mesh (a group of this process alone) the sharded solve
equals ``mppi.plan`` with the generator ``fold_in`` hands rank 0."""

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_dist_workers as W

from quadruped_gym_tpu_torch import parallel
from quadruped_gym_tpu_torch.parallel.mesh import fold_in, group_scope
from quadruped_gym_tpu_torch.solvers import mppi, rollout

S = 8
TOL = 1e-12
BATCH_MESH = {2: (1, 2), 4: (2, 2)}


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"mpc{world}")
    return world, W.run(W.mpc_body, world, tmp, S, BATCH_MESH[world])


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _mppi_reference(world, model, iterations=2):
    """``weighted_update`` over the concatenation of what each rank draws
    from ``fold_in(generator, rank)``, scored in one batch."""
    m, cfg, cost_fn, st, cmd, prev = W.problem(model)
    mcfg = W.mppi_config(S, model, iterations)
    g = W.generator()
    gens = [fold_in(W.clone(g), r) for r in range(world)]
    lo, hi = mppi._ctrl_bounds(m, W.F64, "cpu")
    mean = prev.expand(cfg.horizon, 12)
    for _ in range(iterations):
        seqs = torch.cat([torch.clamp(mean + mcfg.sigma * torch.randn(
            (S // world, cfg.horizon, 12), generator=gr, dtype=W.F64),
            lo, hi) for gr in gens])
        costs = mppi._rollout_costs(m, mcfg, cost_fn, st, seqs, cmd, prev)
        mean, best, mean_c, ent = mppi.weighted_update(seqs, costs,
                                                       mcfg.temperature)
    fold_in(g, 0)  # the caller's generator advances by one draw
    return (mean, best, mean_c, ent), g.get_state()


def test_sharded_rollout_costs_match_batched(ranks):
    world, outs = ranks
    m, cfg, cost_fn, st, cmd, prev = W.problem()
    want = rollout.batched_rollout_cost(m, cfg, cost_fn, st,
                                        W.seqs(S, cfg.horizon), cmd, prev)
    got = torch.cat([o["costs"] for o in outs])
    assert got.shape == (S,)
    _close(got, want)


@pytest.mark.parametrize("model", ["mpc_plant", "planning"],
                         ids=["oracle", "fused"])
def test_sharded_mppi_matches_plan_over_all_draws(ranks, model):
    world, outs = ranks
    want, gen_state = _mppi_reference(world, model)
    for o in outs:
        for f, g, w in zip(mppi.PlanResult._fields, o[model], want):
            _close(g, w, msg=f"{model} {f}")
        assert torch.equal(o[model + " generator"], gen_state)


def test_sharded_batch_mppi_matches_fold_structure(ranks):
    world, outs = ranks
    ndata, nsample = BATCH_MESH[world]
    m, cfg, cost_fn, *_ = W.problem()
    mcfg = W.mppi_config(S, "mpc_plant")
    states, cmds, means, prevs = W.scenarios(2 * ndata)
    lo, hi = mppi._ctrl_bounds(m, W.F64, "cpu")
    want = []
    for d in range(ndata):
        rank_gens = [fold_in(fold_in(W.generator(), d), s)
                     for s in range(nsample)]
        for b in range(2):
            gens = [fold_in(g, b) for g in rank_gens]
            i = 2 * d + b
            st = type(states)(*(x[i] for x in states))
            cmd = type(cmds)(*(x[i] for x in cmds))
            mean = means[i]
            for _ in range(mcfg.iterations):
                seqs = torch.cat([torch.clamp(mean + mcfg.sigma * torch.randn(
                    (S // nsample, cfg.horizon, 12), generator=g,
                    dtype=W.F64), lo, hi) for g in gens])
                costs = rollout.batched_rollout_cost(
                    m, cfg, cost_fn, st, seqs, cmd, prevs[i])
                mean, best, _, _ = mppi.weighted_update(seqs, costs,
                                                        mcfg.temperature)
            want.append((mean[0], torch.cat([mean[1:], mean[-1:]]), best))
    for r, o in enumerate(outs):
        d = r // nsample  # the data axis is the mesh's first
        ctrl, shifted, best = o["batch"]
        assert ctrl.shape == (2, 12) and shifted.shape == (2, 2, 12)
        for b in range(2):
            for g, w in zip((ctrl[b], shifted[b], best[b]), want[2 * d + b]):
                _close(g, w, msg=f"rank {r} scenario {b}")


def test_replicated_results_are_equal_in_every_bit(ranks):
    world, outs = ranks
    nsample = BATCH_MESH[world][1]
    for o in outs[1:]:
        for model in ("mpc_plant", "planning"):
            for a, b in zip(o[model], outs[0][model]):
                assert torch.equal(a, b), model
    # over the sample group of each data index
    for r, o in enumerate(outs):
        peer = outs[r - r % nsample]["batch"]
        for a, b in zip(o["batch"], peer):
            assert torch.equal(a, b)


def test_world_one_mesh_matches_plan():
    """A group of this process alone: every all-reduce is the identity,
    so the sharded solve is ``mppi.plan`` with ``fold_in(generator, 0)``
    (JAX's ``test_sharded_mppi_matches_single_shard_semantics``)."""
    assert not dist.is_initialized()
    m, cfg, cost_fn, st, cmd, prev = W.problem()
    mcfg = W.mppi_config(S, "mpc_plant")
    mean = prev.expand(cfg.horizon, 12)
    with group_scope():
        mesh = parallel.make_mesh(device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        got = parallel.sharded_mppi_plan(m, mcfg, cost_fn, st, mean, cmd,
                                         prev, W.generator(), mesh)
    assert not dist.is_initialized()
    want = mppi.plan(m, mcfg, cost_fn, st, mean, cmd, prev,
                     fold_in(W.generator(), 0))
    for f, g, w in zip(mppi.PlanResult._fields, got, want):
        _close(g, w, msg=f)
    assert torch.equal(got.best_cost, want.best_cost)


def test_fold_in_gives_distinct_streams():
    g = W.generator()
    a0, a1 = fold_in(W.clone(g), 0), fold_in(W.clone(g), 1)
    b0 = fold_in(W.clone(g), 0)
    draws = [torch.randn(4, generator=x) for x in (a0, a1, b0)]
    assert not torch.equal(draws[0], draws[1])  # per rank
    assert torch.equal(draws[0], draws[2])  # replicated: the same stream
    c0, c1 = fold_in(g, 0), fold_in(g, 0)  # per call: g advances
    assert not torch.equal(torch.randn(4, generator=c0),
                           torch.randn(4, generator=c1))


def test_make_mesh_refuses_a_shape_that_does_not_fit():
    with group_scope():
        with pytest.raises(ValueError, match="does not hold"):
            parallel.make_mesh((parallel.DATA_AXIS, parallel.SAMPLE_AXIS),
                               (2, 1), device="cpu")
        with pytest.raises(ValueError, match="does not hold"):
            parallel.make_mesh((parallel.SAMPLE_AXIS,), (1, 1), device="cpu")
        mesh = parallel.make_mesh((parallel.DATA_AXIS, parallel.SAMPLE_AXIS),
                                  device="cpu")
        assert mesh.shape == (1, 1)
        assert mesh.mesh_dim_names == ("data", "sample")
        assert [str(p) for p in parallel.replicated(mesh)] == ["R", "R"]
        assert [str(p) for p in parallel.sharded_on(
            mesh, parallel.SAMPLE_AXIS, 3, 0)] == ["R", "S(0)"]
        with pytest.raises(RuntimeError, match="(?i)nccl"):
            parallel.make_mesh(device="cuda")
    assert not dist.is_initialized()


def test_sharded_batch_result_fields_match_jax():
    from quadruped_gym_tpu.parallel import sharded_mpc as jax_sharded

    from quadruped_gym_tpu_torch.parallel import sharded_mpc

    assert (sharded_mpc.ShardedBatchResult._fields
            == jax_sharded.ShardedBatchResult._fields == ("costs",))
    costs = torch.arange(4.0)
    assert sharded_mpc.ShardedBatchResult(costs=costs).costs is costs
