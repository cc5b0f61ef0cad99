"""A cell on several cards on the CPU: ``planning-mppi-4rank`` through
``harness.run_cell`` over gloo ranks at a tiny size (S=16 a rank, H=3),
rank 0 a process of its own (``_ranks_run.py``) with a time limit; the
faults that must read ``correct`` false; a rank that fails; a parent
that dies; and the collectives' reader on a made-up trace."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from benchmark.tests import _rank_faults
from benchmark.tests._bench import ROOT

from benchmark import harness

RUNNER = os.path.join(ROOT, "benchmark", "tests", "_ranks_run.py")
LIMIT_S = 120  # each run's own time limit
FAULTS = "benchmark.tests._rank_faults:"


def _run(tmp_path, *argv, timeout=LIMIT_S):
    """The runner in a process of its own, its temporary files (the
    ranks' job directory) under ``tmp_path``; asserts that no rank is
    left behind."""
    out = subprocess.run(
        [sys.executable, RUNNER, *map(str, argv)], cwd=ROOT,
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    assert _ranks_alive(tmp_path) == [], out.stderr[-2000:]
    return out


def _ranks_alive(tmp_path) -> list:
    """The processes whose command line names a job under ``tmp_path``."""
    alive = []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read().decode(errors="replace")
        except OSError:
            continue
        if "--job" in cmd and str(tmp_path) in cmd:
            alive.append(int(pid))
    return alive


def _line(out) -> dict:
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_four_ranks_run_and_are_correct(tmp_path):
    out = _run(tmp_path, "run", 4, 2147484001, 0.5, 0)
    line = _line(out)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert line["device"] == {"platform": "cpu", "kind": "cpu", "count": 4,
                              "memory_peak_bytes": 0}
    assert set(line["metrics"]) == {"rollouts_per_s", "setup_s"}
    assert list(line)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith(
        "check solves_off_share ")


def test_traced_run_reads_rank_zero(tmp_path):
    """Rank 0 traces; on the CPU the trace sees no B1 and no collective
    kernel on a card: the run fails and prints no 0."""
    out = _run(tmp_path, "run", 2, 2147484003, 0.5, 1)
    assert out.returncode == 5, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "nccl_ms.mppi4" in out.stderr and "b1_roofline_pct.mppi" in out.stderr


@pytest.mark.parametrize("fault", _rank_faults.FAULTS)
def test_fault_is_not_correct(tmp_path, fault):
    line = _line(_run(tmp_path, "run", 2, 2147484007, 0.5, 0, FAULTS + fault))
    assert line["correct"] is False, line["checks"]


def test_control_reads_far_above_the_program(tmp_path):
    out = _run(tmp_path, "control", 2, 2147484011)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    lim = harness.load_cell("planning-mppi-4rank").workload["limits"]
    prog, ctl = r["program"], r["control"]
    assert prog["solves_off"] == 0
    assert all(prog[k] <= lim[k] for k in lim)
    assert ctl["solves_off_share"] > lim["solves_off_share"]
    assert ctl["cost_gap_median"] > 10 * prog["cost_gap_median"]


def test_rank_failing_in_setup_ends_the_run(tmp_path):
    t0 = time.monotonic()
    out = _run(tmp_path, "run", 4, 2147484013, 0.5, 0,
               FAULTS + "raise_in_setup_on_rank_1")
    assert out.returncode == 7, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "benchmark: rank 1 exited with code 1" in out.stderr
    assert time.monotonic() - t0 < LIMIT_S


def test_ranks_exit_when_rank_zero_dies(tmp_path):
    proc = subprocess.Popen(
        [sys.executable, RUNNER, "run", "3", "2147484017", "300", "0"],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        env={**os.environ, "TMPDIR": str(tmp_path)})
    try:
        deadline = time.monotonic() + 60
        while len(_ranks_alive(tmp_path)) < 2:
            assert proc.poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        time.sleep(2.0)
    finally:
        proc.kill()
        proc.wait(timeout=30)
    deadline = time.monotonic() + 15
    while _ranks_alive(tmp_path) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert _ranks_alive(tmp_path) == []


def test_too_few_cards_exits_at_once(tmp_path):
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "planning-mppi-4rank", "--seed", "2147484019",
         "--seconds", "30", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=LIMIT_S,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": "", "TMPDIR": str(tmp_path)})
    assert out.returncode == 3 and out.stdout.strip() == ""
    assert "needs 4 CUDA device(s)" in out.stderr
    assert time.monotonic() - t0 < 60
    assert os.listdir(tmp_path) == []  # no group was started


def _nccl_ms(events):
    reqs = [harness.Request(0.0, 0.1, 262144), harness.Request(0.1, 0.2, 262144)]
    ctx = harness.Context(
        cell=harness.load_cell("planning-mppi-4rank"), seed=0, setup_s=1.0,
        requests=reqs, trace=harness.Trace(events, 0.2),
        peaks=harness.load_json(harness.BENCH_DIR, "peaks.json"))
    return harness.load_module(
        os.path.join(harness.BENCH_DIR, "metrics", "nccl_ms.mppi4.py"),
        "m").read(ctx)


def test_nccl_reader_is_the_median_collective_time_a_solve():
    ev = harness.DeviceEvent
    b1 = "void qg::fused_rollout_kernel<1>(qg::LegModel<float>)"
    ar = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    bc = "ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    events = []
    for i, wait in enumerate((500.0, 2000.0, 800.0, 100.0)):
        t = i * 100_000.0
        events += [ev(b1, t, t + 90_000.0),
                   ev(ar, t + 90_000.0, t + 90_000.0 + wait),  # MIN: the wait
                   ev(ar, t + 95_000.0, t + 95_020.0),
                   ev(ar, t + 95_100.0, t + 95_130.0),
                   ev(bc, t + 99_000.0, t + 99_010.0)]
    # three whole solves (the last B1 closes none): 560, 2060 and 860 us
    assert _nccl_ms(events) == pytest.approx(0.86)
    assert _nccl_ms([e for e in events if "nccl" not in e.name]) is None
    assert _nccl_ms(events[:5]) is None  # one B1
