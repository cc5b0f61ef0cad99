"""``benchmark/counts/`` recounts exactly the frozen numbers that the
configuration files hold; the MPC traffic's bank of start states is a
walk."""

import os

import pytest

from benchmark.tests._bench import ROOT  # noqa: F401

from benchmark.counts import derive

CONFIGS = ("planning-2x4", "fast-plant-4x8")


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_match_config(name):
    cfg = derive.load(name)
    assert derive.ops_per_rollout_step(cfg) == cfg["ops_per_rollout_step"]
    for key, value in {**derive.substep_ops(cfg), **derive.true_bytes(cfg)}.items():
        assert cfg[key] == value
    # a rollout step is frame_skip substeps, the sensors, then the stage cost
    assert (cfg["frame_skip"] * cfg["ops_per_substep"] + cfg["ops_sensors"]
            < cfg["ops_per_rollout_step"])


def test_actor_count_matches_traffic():
    tr = derive.load_traffic("env-2k")
    assert derive.actor_ops(tr, derive.obs_dim(tr)) == tr["actor_ops_per_env"]


def test_counts_known_values():
    """The leg engine's operations a rollout control step at frame_skip 5,
    as the port's own count gave them (planning 2/4, fast plant 4/8)."""
    assert derive.load("planning-2x4")["ops_per_rollout_step"] == 332082
    assert derive.load("fast-plant-4x8")["ops_per_rollout_step"] == 1054132
    # the substep kernel's count for 5 substeps, as the port's gave it
    fp = derive.load("fast-plant-4x8")
    assert 5 * fp["ops_per_substep"] + fp["ops_sensors"] == 1053992


@pytest.mark.parametrize("name", CONFIGS)
def test_stance_matches_config(name):
    cfg = derive.load(name)
    got = derive.stance(cfg, cfg["settle_steps"])
    for key, values in got.items():
        assert values == pytest.approx(cfg["stance"][key], rel=1e-12, abs=1e-12)
    # settled: on the floor and at rest
    assert max(abs(v) for v in got["qvel"]) < 1e-3
    assert 0.1 < got["qpos"][2] < 0.2


def test_walk_bank():
    """The MPC traffic's start states: 64 states of a walk, upright,
    moving forward, in the layout the drivers read."""
    import json
    import math

    with open(os.path.join(ROOT, "benchmark", "banks", "walk-0.2.json")) as f:
        bank = json.load(f)
    lay = bank["layout"]
    width = lay["nq"] + lay["nv"] + lay["na"] + lay["nsens"]
    assert len(bank["states"]) == 64
    assert all(len(s) == width and all(map(math.isfinite, s)) for s in bank["states"])
    assert bank["walk"]["survived"] == bank["walk"]["envs"]
    assert 0.1 < bank["walk"]["mean_vx_mps"] < 0.3
    for s in bank["states"]:
        qw, qx, qy, qz = s[3:7]
        assert 1.0 - 2.0 * (qx * qx + qy * qy) > 0.8  # the body's z axis up
        assert 0.05 < s[2] < 0.2


def test_walk_bank_writer_runs():
    from benchmark.banks import walk

    res = walk.walk(envs=2, keep=[1, 2], seed=0, speed=0.2)
    lay = res["layout"]
    assert len(res["states"]) == 4
    assert len(res["states"][0]) == lay["nq"] + lay["nv"] + lay["na"] + lay["nsens"]
