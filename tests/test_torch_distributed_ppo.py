"""The port's data-parallel PPO (``rl/distributed.py``, ``rl/train.py
--distributed``) on gloo ranks on the CPU, float64: the counterpart of the
JAX package's ``tests/test_distributed_ppo.py``.

- Against JAX: the snapshot ``tests/torch_parallel_refs.npz``
  (``scripts/snapshot_torch_parallel_refs.py``) holds one JAX
  ``make_distributed_update`` on 2 virtual devices, its start and each
  shard's draws; the port's 2 ranks, handed the same, land on its
  parameters and metrics within 1e-8. The ``slow`` test recomputes the
  snapshot live.
- 2 ranks from one seed: after an update the parameters are equal in
  every bit on both ranks and have moved; a second update chains.
- ``train.main --distributed`` in one process (a group of one) writes the
  CSV and the global checkpoint; over 2 ranks, a run saved after one
  iteration and resumed equals an uninterrupted one in every bit."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch_dist_workers as W
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu_torch.rl import ppo, train
from quadruped_gym_tpu_torch.runtime import checkpoint
from quadruped_gym_tpu_torch.utils.metrics import read_reward_csv

TOL = 1e-8


def _ref():
    with np.load(W.snapshot_script().OUT) as data:
        return {k: data[k] for k in data.files}


def test_update_matches_jax_snapshot(tmp_path):
    ref = _ref()
    outs = W.run(W.jax_snapshot_body, 2, tmp_path)
    for r, o in enumerate(outs):
        for i, got in enumerate(o["params"]):
            np.testing.assert_allclose(got.numpy(), ref[f"want/leaf_{i}"],
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} leaf {i}")
        for f, got in o["metrics"].items():
            np.testing.assert_allclose(got.numpy(), ref[f"metrics/{f}"],
                                       rtol=TOL, atol=TOL, err_msg=f)
    for a, b in zip(outs[0]["params"], outs[1]["params"]):
        assert torch.equal(a, b)
    # the update moved every leaf
    n = sum(k.startswith("want/") for k in ref)
    assert all(not np.allclose(ref[f"want/leaf_{i}"], ref[f"init/leaf_{i}"])
               for i in range(n))


def test_two_rank_updates_replicate_and_chain(tmp_path):
    a, b = W.run(W.ppo_body, 2, tmp_path)
    for k in range(3):
        for x, y in zip(a["params"][k], b["params"][k]):
            assert torch.equal(x, y), f"after update {k}"
    for k in (1, 2):  # each update moves the network
        assert any(not torch.equal(x, y) for x, y in
                   zip(a["params"][k], a["params"][k - 1]))
    for ma, mb in zip(a["metrics"], b["metrics"]):  # averaged: replicated
        for x, y in zip(ma, mb):
            assert torch.equal(x, y) and bool(torch.isfinite(x).all())
    assert torch.equal(a["generator"], b["generator"])
    assert a["update_idx"] == b["update_idx"] == 2
    # each rank steps its own half of the envs, under its own actions
    assert a["obs"].shape == b["obs"].shape == (2, 52)
    assert not torch.equal(a["obs"], b["obs"])


def test_train_main_distributed_in_one_process(tmp_path):
    out = str(tmp_path / "run")
    assert not dist.is_initialized()
    ts, its = train.main(["--distributed", "--output", out, "--iterations",
                          "2", "--finetune-iterations", "1"]
                         + W.TRAIN_ARGS, device="cpu")
    assert not dist.is_initialized()  # the group it started is gone
    assert [it.index for it in its] == [0, 1]  # no fine-tune phase
    rows, _, comp, _ = read_reward_csv(os.path.join(out,
                                                    "rewards_continuous.csv"))
    assert list(rows) == list(range(8)) and np.isfinite(comp).all()
    arrays, step = checkpoint.read(os.path.join(out, "policy"))
    assert step == 2 and int(ts.update_idx) == 2
    assert ts.obs.shape == (4, 52)
    restored, _ = checkpoint.restore(os.path.join(out, "policy"), ts)
    assert torch.equal(restored.obs, ts.obs)


def test_two_rank_resume_equals_uninterrupted(tmp_path):
    outs = W.run(W.train_body, 2, tmp_path / "ranks", str(tmp_path))
    for o in outs:
        assert o["index"] == [1] and o["group_kept"]
        a, b = o["resumed"], o["whole"]
        for x, y in zip(a["net"] + [a["obs"]] + a["phys"],
                        b["net"] + [b["obs"]] + b["phys"]):
            assert torch.equal(x, y)
        assert torch.equal(a["generator"], b["generator"])
    for x, y in zip(outs[0]["whole"]["net"], outs[1]["whole"]["net"]):
        assert torch.equal(x, y)  # replicated
    csv = [read_reward_csv(str(tmp_path / d / "rewards_continuous.csv"))
           for d in ("resumed", "whole")]
    for x, y in zip(*csv):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    # the checkpoint holds the global state: all 4 envs
    arrays, step = checkpoint.read(str(tmp_path / "whole" / "policy"))
    assert step == 2
    obs = [a for a in arrays.values() if a.shape == (4, 52)]
    assert len(obs) == 1 and np.array_equal(
        obs[0], np.concatenate([o["whole"]["obs"].numpy() for o in outs]))


def test_update_fn_axis_name_needs_a_mesh():
    env_cfg, cfg = W.snapshot_script().port_configs()
    with pytest.raises(ValueError, match="needs the mesh"):
        ppo.update_fn(None, env_cfg, cfg, axis_name="data")


@pytest.mark.slow
def test_snapshot_matches_live_jax():
    """``tests/torch_parallel_refs.npz`` is what the JAX package computes
    now (one jitted ``shard_map`` update on 2 virtual CPU devices)."""
    live = W.snapshot_script().jax_results()
    ref = _ref()
    assert set(live) == set(ref)
    for k in ref:
        np.testing.assert_allclose(live[k], ref[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)
