"""The port's GPipe horizon pipeline (``parallel/pipeline.py``) over 2 and
4 gloo stages on the CPU, float64: the counterpart of the JAX package's
``tests/test_pipeline.py``.

``pipelined_rollout_cost`` with M = 2 and 4 microbatches equals
``batched_rollout_cost`` (1e-12: the same physics steps in the same
order, the cost sum regrouped into per-stage partial sums; the JAX test
holds its own at ~1e-12), replicated in every bit on every stage;
``pipelined_mppi_plan`` equals the unpipelined update on the same draws;
a horizon the stages do not divide and a batch the microbatches do not
divide raise ``ValueError``."""

import numpy as np
import pytest
import torch
import torch_dist_workers as W

from quadruped_gym_tpu_torch import parallel
from quadruped_gym_tpu_torch.parallel.mesh import group_scope
from quadruped_gym_tpu_torch.solvers import mppi, rollout

S, H = 8, 4
MICROBATCHES = (2, 4)
TOL = 1e-12


@pytest.fixture(scope="module", params=[2, 4], ids=["2stages", "4stages"])
def stages(request, tmp_path_factory):
    world = request.param
    tmp = tmp_path_factory.mktemp(f"pipe{world}")
    return world, W.run(W.pipeline_body, world, tmp, S, H, MICROBATCHES)


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL,
                               atol=TOL, err_msg=msg)


@pytest.mark.parametrize("M", MICROBATCHES, ids=lambda M: f"M{M}")
def test_pipelined_costs_match_sequential(stages, M):
    world, outs = stages
    m, cfg, cost_fn, st, cmd, prev = W.problem(H=H)
    want = rollout.batched_rollout_cost(m, cfg, cost_fn, st, W.seqs(S, H),
                                        cmd, prev)
    for o in outs:
        assert o[M].shape == (S,)
        _close(o[M], want, f"{world} stages, {M} microbatches")
        assert torch.equal(o[M], outs[0][M])


def test_pipelined_mppi_plan_matches_unpipelined(stages):
    world, outs = stages
    m, cfg, cost_fn, st, cmd, prev = W.problem(H=H)
    mcfg = W.mppi_config(S, "mpc_plant", iterations=1, H=H)
    eps = mcfg.sigma * torch.randn((S, H, 12), generator=W.generator(),
                                   dtype=W.F64)
    seqs = torch.clamp(prev + eps, -1.0, 1.0)
    costs = rollout.batched_rollout_cost(m, cfg, cost_fn, st, seqs, cmd,
                                         prev)
    mean, best, _, _ = mppi.weighted_update(seqs, costs, mcfg.temperature)
    for o in outs:
        ctrl, new_mean, cmin = o["plan"]
        _close(new_mean, mean)
        _close(ctrl, mean[0])
        _close(cmin, best)


def test_pipeline_refuses_what_does_not_divide(stages):
    world, outs = stages
    for o in outs:
        assert len(o["errors"]) == 2
        assert f"horizon {world + 1} not divisible by {world}" in \
            o["errors"][0]
        assert f"batch {S} not divisible by 3 microbatches" in o["errors"][1]


def test_one_stage_is_the_sequential_rollout():
    """A pipeline of one stage: one segment, the microbatches one after
    another, and the same sums as ``batched_rollout_cost`` in every bit."""
    m, cfg, cost_fn, st, cmd, prev = W.problem(H=H)
    want = rollout.batched_rollout_cost(m, cfg, cost_fn, st, W.seqs(S, H),
                                        cmd, prev)
    with group_scope():
        mesh = parallel.make_mesh((parallel.STAGE_AXIS,), device="cpu")
        got = parallel.pipelined_rollout_cost(
            m, cfg, cost_fn, st, W.seqs(S, H), cmd, prev, mesh,
            num_microbatches=2)
        with pytest.raises(ValueError, match="not divisible by 3"):
            parallel.pipelined_rollout_cost(
                m, cfg, cost_fn, st, W.seqs(S, H), cmd, prev, mesh,
                num_microbatches=3)
    assert torch.equal(got, want)
