"""The port's spans (``utils/profiling.py``: ``span``, ``spans``,
``clear_spans``, ``to_unix_ns`` and the Chrome export of ``trace``) on the
CPU.

A span records only while a ``torch.profiler`` session runs in the
process, and never through ``record_function``; nested spans know their
parent and their request's root; the MPC and env paths open their named
span trees; a root's clock anchor puts the profiler's own events (Unix
ns) inside the spans that issued them; ``trace`` writes the spans into
its ``trace.json`` on the trace's clock."""

import json
import os
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from quadruped_gym_tpu_torch.envs import vector_env
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.physics.engine import make_state
from quadruped_gym_tpu_torch.rl import networks
from quadruped_gym_tpu_torch.runtime import mpc_runtime
from quadruped_gym_tpu_torch.solvers import mppi, rollout
from quadruped_gym_tpu_torch.tasks import commands, walking
from quadruped_gym_tpu_torch.utils import profiling

CENTERS = [0.0, 0.0, -0.5] * 4


@pytest.fixture(autouse=True)
def no_spans(monkeypatch):
    """Every test starts with no spans, and none may reach
    ``record_function``."""

    def refuse(*args, **kwargs):
        raise AssertionError("a span called record_function")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _cpu_session():
    return profile(activities=[ProfilerActivity.CPU])


def _tree(recorded):
    """(name, parent's name) of each span in the order they opened (None
    on a root)."""
    return [(s.name, None if s.parent < 0 else recorded[s.parent].name)
            for s in recorded]


def _plan_inputs(engine):
    m = spec.get_planning_model()
    H, dt = 3, torch.float64
    cfg = mpc_runtime.MPCConfig(mppi=mppi.MPPIConfig(
        num_samples=8, rollout=rollout.RolloutConfig(horizon=H, frame_skip=2),
        lane=True, lane_engine_impl=engine, lane_newton_iterations=2,
        lane_ls_iterations=4))
    centers = torch.tensor(CENTERS, dtype=dt)
    carry = mpc_runtime.MPCCarry(
        mean=centers[None].repeat(H, 1), sigma=torch.zeros((H, 12), dtype=dt),
        prev_ctrl=centers, generator=torch.Generator().manual_seed(0))
    st = make_state(m, dtype=dt, device="cpu")
    st = st._replace(qvel=torch.full((m.nv,), 0.05, dtype=dt))
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=dt),
                        torch.tensor(0.0, dtype=dt))
    return m, cfg, rollout.make_cost_fn(m), carry, st, cmd


def _env_inputs(n=4):
    m = spec.get_planning_model()
    cfg = walking.WalkingConfig(
        max_time=5.0, frame_skip=2, settling_time=0.004, obs_window=3,
        partial_obs=True, solver_iterations=4, dtype=torch.float64,
        reset_options=commands.SampleOptions(
            fixed_heading_angle=0.4, fixed_velocity_angle=-0.7,
            fixed_speed=0.3))
    gen = torch.Generator().manual_seed(0)
    st, obs = walking.reset(m, cfg, n, gen)
    net = networks.ActorCritic(networks.NetConfig(
        obs_dim=walking.obs_size(cfg, m), act_dim=m.nu, hidden=(8,)),
        torch.float64, "cpu")
    return m, cfg, st, obs, net, gen


def test_no_profiler_no_spans():
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    ctrl, _, _ = mpc_runtime.plan_and_act(*_plan_inputs("leg"))
    m, cfg, st, obs, net, gen = _env_inputs()
    action, _ = networks.sample_action(net, obs, gen)
    vector_env.batched_autoreset_step(m, cfg, st, action, gen,
                                      engine_impl="pallas")
    assert profiling.spans() == []
    assert bool(torch.isfinite(ctrl).all())


def test_nested_spans_know_parent_and_root():
    with _cpu_session():
        for _ in range(2):
            with profiling.span("a"):
                with profiling.span("b"):
                    with profiling.span("c"):
                        pass
                with profiling.span("d"):
                    pass
        with pytest.raises(KeyError):
            with profiling.span("raises"):
                with profiling.span("inside"):
                    raise KeyError("x")
        with profiling.span("after"):
            pass
    got = profiling.spans()
    assert [(s.name, s.parent, s.root) for s in got] == [
        ("a", -1, 0), ("b", 0, 0), ("c", 1, 0), ("d", 0, 0),
        ("a", -1, 4), ("b", 4, 4), ("c", 5, 4), ("d", 4, 4),
        ("raises", -1, 8), ("inside", 8, 8), ("after", -1, 10)]
    for s in got:
        assert s.start_ns <= s.end_ns
        assert (s.unix_ns > 0) == (s.parent < 0)  # anchors on roots alone
        if s.parent >= 0:
            p = got[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    # after the session a span records nothing again
    with profiling.span("late"):
        pass
    assert len(profiling.spans()) == len(got)
    profiling.clear_spans()
    assert profiling.spans() == []


def test_a_roots_anchor_is_read_again_after_a_preemption(monkeypatch):
    """The anchor's wall-clock reading is taken between two perf_counter
    readings; where they lie over 20 us apart (the thread lost the
    processor) the pair is read again, and the root's ``unix_ns`` is its
    start on the wall clock through the tight pair."""
    perf = iter([0, 10_000_000,  # the first pair: 10 ms apart
                 20_000_000, 20_000_400,  # the second: 0.4 us
                 20_001_000,  # the root's start
                 20_002_000, 20_003_000,  # the child's start and end
                 20_004_000])  # the root's end
    wall = iter([5_000_000_000, 7_000_000_000])

    class Clock:
        perf_counter_ns = staticmethod(lambda: next(perf))
        time_ns = staticmethod(lambda: next(wall))

    with _cpu_session():
        monkeypatch.setattr(profiling, "time", Clock)
        with profiling.span("root"):
            with profiling.span("child"):
                pass
        monkeypatch.undo()
    root, child = profiling.spans()
    assert root.start_ns == 20_001_000
    assert root.unix_ns == 7_000_000_000 + 20_001_000 - 20_000_200
    assert profiling.to_unix_ns(child.start_ns, root) == (
        root.unix_ns + 1_000)


@pytest.mark.parametrize("engine,inner", [
    ("leg", []),
    # on the CPU the wrapper runs its plain version, the leg engine's
    # rollout (no launch span: nothing is launched)
    ("fused", [("cuda_engine.fused_rollout_cost",
                "rollout.lane_batched_rollout_cost"),
               ("rollout.lane_batched_rollout_cost",
                "cuda_engine.fused_rollout_cost")]),
])
def test_plan_and_act_span_tree(engine, inner):
    """One solve: ``plan_and_act`` is the root of MPPI's spans."""
    args = _plan_inputs(engine)
    with _cpu_session():
        ctrl, _, _ = mpc_runtime.plan_and_act(*args)
    assert _tree(profiling.spans()) == [
        ("plan_and_act", None),
        ("mppi.plan", "plan_and_act"),
        ("mppi.sample", "mppi.plan"),
        ("rollout.lane_batched_rollout_cost", "mppi.plan"),
        *inner,
        ("mppi.weighted_update", "mppi.plan")]
    assert bool(torch.isfinite(ctrl).all())


def test_env_step_span_trees():
    """The actor and the step are the two roots of an env step; the step
    opens the task layer, its physics (B2's wrapper, on the CPU its plain
    version) and the auto-reset."""
    m, cfg, st, obs, net, gen = _env_inputs()
    with _cpu_session():
        action, _ = networks.sample_action(net, obs, gen)
        vector_env.batched_autoreset_step(m, cfg, st, action, gen,
                                          engine_impl="pallas")
    got = profiling.spans()
    assert _tree(got) == [
        ("networks.sample_action", None),
        ("vector_env.batched_autoreset_step", None),
        ("walking.task_step", "vector_env.batched_autoreset_step"),
        ("walking.physics", "walking.task_step"),
        ("cuda_engine.control_step", "walking.physics"),
        ("vector_env.autoreset", "vector_env.batched_autoreset_step")]
    assert [s.root for s in got] == [0, 1, 1, 1, 1, 1]


def test_spans_hold_the_profilers_events_on_the_mapped_clock():
    """Every ``aten::`` op the CPU profiler saw inside a span lies inside
    that span once the span is mapped through its root's anchor onto the
    profiler's clock, and no op issued outside it does; a millisecond
    apart, so the clocks' disagreement (~10 us) cannot decide it."""
    x = torch.ones(64, dtype=torch.float64)
    with _cpu_session() as prof:
        for _ in range(3):
            torch.add(x, 1.0)  # between requests: in no span
            with profiling.span("request"):
                time.sleep(1e-3)
                with profiling.span("work"):
                    time.sleep(1e-3)
                    torch.mul(x, 2.0).sum()
                    time.sleep(1e-3)
                time.sleep(1e-3)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ops = [(ev.name, t0 + int(ev.time_range.start * 1e3),
            t0 + int(ev.time_range.end * 1e3))
           for ev in prof.events() if ev.name.startswith("aten::")]
    got = profiling.spans()
    work = [(profiling.to_unix_ns(s.start_ns, got[s.root]),
             profiling.to_unix_ns(s.end_ns, got[s.root]))
            for s in got if s.name == "work"]
    assert len(work) == 3
    assert {n for n, _, _ in ops} >= {"aten::add", "aten::mul", "aten::sum"}
    for name, a, b in ops:  # the add alone was issued outside "work"
        hits = [lo <= a and b <= hi for lo, hi in work]
        assert sum(hits) == (name != "aten::add"), (name, a, b, work)


def test_trace_writes_the_spans(tmp_path):
    """``trace.json`` holds each span on a host track of its own, on the
    trace's clock: the matrix product lies inside the span that issued it."""
    d = str(tmp_path / "trace")
    x = torch.ones((64, 64))
    with profiling.trace(d):
        with profiling.span("outer"):
            time.sleep(1e-3)
            with profiling.span("inner"):
                time.sleep(1e-3)
                (x @ x).sum()
                time.sleep(1e-3)
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    mine = {ev["name"]: ev for ev in events if ev.get("cat") == "span"}
    assert set(mine) == {"outer", "inner"}
    outer, inner = mine["outer"], mine["inner"]
    assert outer["args"] == {"parent": -1, "root": 0}
    assert inner["args"] == {"parent": 0, "root": 0}
    assert outer["ts"] < inner["ts"]
    assert inner["ts"] + inner["dur"] < outer["ts"] + outer["dur"]
    mm = [ev for ev in events if ev.get("name") == "aten::mm"]
    assert len(mm) == 1
    assert inner["ts"] < mm[0]["ts"]
    assert mm[0]["ts"] + mm[0]["dur"] < inner["ts"] + inner["dur"]
    assert [ev["args"]["name"] for ev in events
            if ev.get("ph") == "M" and ev.get("tid") == inner["tid"]
            and ev.get("pid") == inner["pid"]] == ["spans"]
    assert inner["pid"] == os.getpid()
    assert not [ev for ev in events if ev.get("tid") == inner["tid"]
                and ev.get("cat") != "span" and ev.get("ph") != "M"]


def test_a_trace_without_spans_is_left_as_exported(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d):
        (torch.ones(8) * 2).sum()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert not [ev for ev in events if ev.get("cat") == "span"]
    assert np.any(["mul" in str(ev.get("name")) for ev in events])


def test_packing_a_model_is_a_span():
    """Packing and uploading a model for the kernels
    (``cuda_engine._model_buffer``, once per model, type and device) is
    the span ``cuda_engine.pack_model``; a cached model opens none."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    m = spec.get_planning_model(96)  # a model no other test packs
    m.__dict__.pop("_cuda_model_cache", None)
    with _cpu_session():
        cuda_engine._model_buffer(m, torch.float32, "cpu")
        cuda_engine._model_buffer(m, torch.float32, "cpu")
    assert _tree(profiling.spans()) == [("cuda_engine.pack_model", None)]
