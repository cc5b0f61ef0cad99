"""The benchmark's cell on the ``full`` collision model, ``full-env-2k``,
on the CPU at 8 environments: its driver (``benchmark/traffic/
full_env_steps.py``, whose plain reference steps the lane engine), its
check, its refusal of a program that would not take the substep kernel,
its metric readers, and its configuration's frozen counts."""

import dataclasses
import os

import pytest
import torch

from benchmark import harness
from benchmark.counts import base_groups, derive
from quadruped_gym_tpu_torch.ops import cuda_engine, lane_engine, leg_engine
from quadruped_gym_tpu_torch.tasks import walking

CELL = "full-env-2k"
# the cell at 8 environments, its own 3 warm-up steps (the pressed step
# presses the states they leave)
TINY_ENV = {"num_envs": 8}


def _driver_module():
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "traffic", "full_env_steps.py"),
        "bench_traffic_full_env_steps")


def test_sound_run_is_correct():
    """The warm-up and a window of one step at 8 environments (the
    run's set-up, window, metrics and check; this test process holds JAX,
    so the command's own refusal of a run that loaded it is not asked):
    the start, the step and the pressed step held to the lane engine's
    reference, correct."""
    c = harness.load_cell(CELL, TINY_ENV)
    res = harness.run_cell(c, 2147483931, 0.001, False, "cpu", 0.0)
    assert res["correct"] is True, res["checks"]
    assert res["look"]["steps_checked"] >= 1
    assert "pressed_envs_off_share" in res["checks"]
    assert res["look"]["pressed_base_touch_share"] > 0.0
    assert set(res["metrics"]) == {"env_steps_per_s", "setup_s"}


def _without_base_groups(m):
    """``m`` with the base's collision geoms (the frame and the hip
    servos) taken out."""
    keep = [g for g, b in enumerate(m.col_geom_bodyid) if b != 1]
    cut = {}
    for f in dataclasses.fields(m):
        if f.name.startswith("col_"):
            v = getattr(m, f.name)
            cut[f.name] = (tuple(v[g] for g in keep) if isinstance(v, tuple)
                           else v[keep])
    return dataclasses.replace(m, **cut)


@pytest.mark.parametrize("program,correct", [("sound", True),
                                             ("no_base_groups", False)])
def test_dropped_base_groups_are_not_correct(program, correct, monkeypatch):
    """Through the harness at 8 environments: the window's robots stand,
    the check's pressed step puts their bases at 0-3 cm, where the hip
    servos touch. A program whose model lacks the base's groups is judged
    not correct, by ``pressed_envs_off_share`` alone; the sound program on
    the same seed is correct."""
    from quadruped_gym_tpu_torch.models import spec as program_spec

    if program == "no_base_groups":
        full = program_spec.get_full_model
        monkeypatch.setattr(program_spec, "get_full_model",
                            lambda: _without_base_groups(full()))
        assert not any(lv < 0 for lv, _ in leg_engine._leg_static(
            program_spec.get_full_model()).col_groups)
    res = harness.run_cell(harness.load_cell(CELL, TINY_ENV), 2147483947,
                           0.001, False, "cpu", 0.0)
    assert res["look"]["pressed_hip_touch_share"] >= 0.5
    assert res["correct"] is correct, res["checks"]
    past = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert past == ([] if correct else ["pressed_envs_off_share"])


def test_setup_refuses_a_program_off_the_kernel(monkeypatch, capsys):
    """Where ``walking.batched_engine(m, "pallas")`` is not the substep
    kernel's wrapper (as on a program whose leg engine refuses ``full``),
    set-up exits at once with one line."""
    monkeypatch.setattr(walking, "batched_engine",
                        lambda m, impl: lane_engine)
    mod = _driver_module()
    drv = mod.Driver(harness.load_cell(CELL, TINY_ENV), 1,
                     torch.device("cpu"))
    with pytest.raises(SystemExit) as exc:
        drv.setup()
    assert exc.value.code != 0
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "substep kernel" in err[0]


def test_counts_match_config():
    """The configuration's frozen counts are what ``benchmark/counts/
    base_groups.py`` derives; on a model the frozen reference takes too it
    counts as ``derive.py`` does."""
    cfg = derive.load("full-4x8")
    for key, value in base_groups.derive_counts(cfg).items():
        assert cfg[key] == value, key
    fp = derive.load("fast-plant-4x8")
    assert base_groups.substep_ops(fp) == derive.substep_ops(fp)
    # the base's groups make the substep ~2.7 times the fast plant's
    assert 2.0 < cfg["ops_per_substep"] / fp["ops_per_substep"] < 3.5


def _read(metric, ctx):
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", metric + ".py"),
        "m").read(ctx)


def test_metric_readers(monkeypatch):
    """``b2_warps_per_sm.full_env`` reads the program's launch counter
    (None without one); ``b2_busy_share_pct.full_env`` B2's share of the
    trace's busy time (None without a B2)."""
    c = harness.load_cell(CELL)
    peaks = harness.load_json(harness.BENCH_DIR, "peaks.json")
    ev = harness.DeviceEvent
    tr = harness.Trace([ev("qg::substep_kernel<x>", 0.0, 600.0),
                        ev("elementwise_kernel", 700.0, 1100.0)], 0.002)
    reqs = [harness.Request(0.0, 0.001, 8), harness.Request(0.001, 0.002, 8)]
    ctx = harness.Context(c, 0, 1.0, reqs, tr, peaks)
    assert _read("b2_busy_share_pct.full_env", ctx) == pytest.approx(60.0)
    none = harness.Context(c, 0, 1.0, reqs,
                           harness.Trace([ev("other", 0.0, 1.0)], 0.002), peaks)
    assert _read("b2_busy_share_pct.full_env", none) is None
    monkeypatch.setattr(cuda_engine, "geometry", {})
    assert _read("b2_warps_per_sm.full_env", ctx) is None
    monkeypatch.setattr(cuda_engine, "geometry", {"substep": {
        "threads": 32, "blocks_per_sm": 3}})
    assert _read("b2_warps_per_sm.full_env", ctx) == 3.0
