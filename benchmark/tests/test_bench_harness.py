"""The harness on the CPU: its files, names and units, which cell reports
what, the window's arithmetic, and the runs that must fail."""

import argparse
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from benchmark.tests._bench import MPC_CELLS, ROOT, TINY

from benchmark import harness

BENCH = harness.load_json(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_manifest_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    assert all(m["better"] in ("lower", "higher") for m in METRICS)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    assert c.chips in (1, 4)
    assert c.workload["config"] == c.config["name"]
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "traffic",
                                       c.traffic["driver"] + ".py"))
    assert c.workload["metrics"] == {
        "end_to_end": [m["name"] for m in c.end_to_end],
        "per_layer": [m["name"] for m in c.per_layer]}
    for m in c.end_to_end + c.per_layer:
        reader = harness.load_module(
            os.path.join(harness.BENCH_DIR, "metrics", m["name"] + ".py"), "r")
        assert callable(reader.read)
    # setup_s, another end-to-end metric and a per-layer metric
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_four_card_cells_are_few():
    """At most a quarter of the cells, rounded down, ask for four cards,
    and one always may."""
    four = [w["name"] for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4), four


def test_config_files():
    for c in BENCH["configs"]:
        cfg = harness.load_json(ROOT, c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert c["file"].startswith("benchmark/")
        assert cfg["source"] == c["source"]


def test_moves_reported_by_each_cell():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in target or cell in target["workloads"], (
                m["name"], cell)


def _ctx(requests, trace=None, cell="planning-replan-4k"):
    return harness.Context(cell=harness.load_cell(cell), seed=0, setup_s=1.0,
                           requests=requests, trace=trace,
                           peaks=harness.load_json(harness.BENCH_DIR, "peaks.json"))


def _read(metric, ctx):
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", metric + ".py"), "m").read(ctx)


def test_rate_is_all_work_over_all_time():
    # uneven solves with host gaps between them: the rate counts the gaps
    reqs, t = [], 0.0
    for i in range(10):
        d = 0.1 + 0.05 * (i % 3)
        reqs.append(harness.Request(t, t + d, 100))
        t += d + 0.02
    rate = _read("rollouts_per_s", _ctx(reqs, cell="planning-mppi-65k"))
    assert rate == pytest.approx(1000 / (reqs[-1].end - reqs[0].start))
    mean_of_rates = np.mean([r.work / (r.end - r.start) for r in reqs])
    assert rate < mean_of_rates


def test_p95_is_over_all_requests():
    rng = np.random.default_rng(0)
    lat = rng.lognormal(-4.4, 0.3, size=1000)
    lat[::37] *= 3.0  # a tail
    reqs, t = [], 0.0
    for x in lat:
        reqs.append(harness.Request(t, t + x, 4096))
        t += x
    p95 = _read("replan_ms_p95", _ctx(reqs))
    assert p95 == pytest.approx(1e3 * np.percentile(lat, 95))
    chunks = np.median([np.percentile(c, 95) for c in np.array_split(lat, 10)])
    assert p95 != pytest.approx(1e3 * chunks)


def test_trace_readers():
    reqs = [harness.Request(0.0, 0.013, 4096), harness.Request(0.014, 0.026, 4096)]
    ev = harness.DeviceEvent
    events = [ev("fused_rollout_kernel(LegModel<float>)", 100.0, 11_100.0),
              ev("randn", 11_100.0, 11_150.0),
              ev("fused_rollout_kernel(LegModel<float>)", 14_100.0, 25_100.0)]
    tr = harness.Trace(events, 0.026)
    ctx = _ctx(reqs, tr)
    cfg, tf = ctx.cell.config, ctx.cell.traffic
    ops = tf["num_samples"] * tf["horizon"] * cfg["ops_per_rollout_step"]
    assert _read("b1_roofline_pct.replan", ctx) == pytest.approx(
        100 * ops / 67e12 / 0.011)
    assert _read("mfu_pct.replan", ctx) == pytest.approx(
        100 * 2 * ops / (0.026 * 67e12))
    assert _read("device_idle_pct.replan", ctx) == pytest.approx(
        100 * (1 - 0.02205 / 0.026))
    assert _read("outside_b1_ms.replan", ctx) == pytest.approx(1.5)
    b = tr.breakdown()
    assert b["device_ops"][0][0].startswith("fused_rollout_kernel")
    assert b["idle_gaps"][0][1] == pytest.approx(0.00295)
    # no B1 event: nothing to read, never 0
    empty = _ctx(reqs, harness.Trace([ev("randn", 0.0, 10.0)], 0.026))
    assert _read("b1_roofline_pct.replan", empty) is None
    assert _read("outside_b1_ms.replan", empty) is None


def test_run_without_card_fails():
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "planning-mppi-65k", "--seed", "2147483700",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def _args(trace, seed=2147483777, seconds=0.5):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=trace)


def test_cpu_run_prints_result(capsys):
    cell = harness.load_cell("planning-replan-4k", TINY)
    assert harness.report(cell, _args(0), "cpu", 0.0) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"replan_ms_p95", "setup_s"}
    assert out.err.strip().splitlines()[-1].startswith("check solves_off_share ")


def test_traced_run_without_b1_fails(capsys):
    """On the CPU the trace sees no B1 event: the run fails, no 0."""
    cell = harness.load_cell("planning-mppi-65k", TINY)
    assert harness.report(cell, _args(1), "cpu", 0.0) == 5
    out = capsys.readouterr()
    assert out.out.strip() == ""
    assert "b1_roofline_pct.mppi" in out.err


@pytest.mark.parametrize("cell", MPC_CELLS)
def test_workload_limits(cell):
    w = harness.load_cell(cell).workload
    assert set(w["limits"]) == {"solves_off_share"}
    # one solve of those checked may be off, not half of them
    assert 1 / w["check_solves"] <= w["limits"]["solves_off_share"] < 0.5
    assert set(w["solve_limits"]) == {"cost_gap", "plan_gap"}
    assert all(0 < v < 1 for v in w["solve_limits"].values())
    S = harness.load_cell(cell).traffic["num_samples"]
    assert w["check_lanes"] == w["check_solves"] * S  # one reference pass
