"""The port's examples and scripts (``examples/torch_*.py``,
``scripts/torch_*.py``) on the CPU, held to the JAX package where they
compute something of their own.

- ``torch_random_rollout``'s chunk under the controls the JAX example
  draws from ``PRNGKey(0)``, against the JAX example's jitted chunk on
  ``mpc_plant`` (0.02 s of substeps, float64, 1e-10).
- ``torch_scenario_sweep``'s scoring (the fused dispatch, whose CPU form
  is the kernel's plain version) with DomainParams made in numpy,
  terrain included, against JAX's ``lane_batched_rollout_cost(
  engine_impl="leg")`` run eagerly (S=8, H=1, frame_skip 2, 1e-10): the
  JAX fused kernel's interpret mode takes over 20 minutes a substep.
- ``torch_kernel_roofline``'s byte formula against the JAX script's own
  lines (read from its source).
- The other entry points run end to end at a tiny size: the walk, the
  latency demo (its plant process and the shm bus), the eval report
  (equal to ``rl.evaluate.eval_rollout``), the export (the trainer's
  network back in every bit); and each raises without a card unless
  asked for the CPU."""

import ast
import dataclasses
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.physics import engine as jengine
from quadruped_gym_tpu.solvers import rollout as jrollout
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.physics.engine import make_state
from quadruped_gym_tpu_torch.rl import evaluate, train
from quadruped_gym_tpu_torch.runtime import checkpoint
from quadruped_gym_tpu_torch.solvers import rollout as trollout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = os.path.join(REPO, "artifacts", "walk_r5", "policy_params")
F64 = torch.float64
TOL = 1e-10


def _load(folder, name):
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", os.path.join(REPO, folder, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_random_rollout_chunk_matches_the_jax_example():
    rr = _load("examples", "torch_random_rollout")
    jm = jspec.get_model(collision_geom_prefixes=jspec.MPC_COLLISION_PREFIXES)
    tm = tspec.get_mpc_plant_model()
    n = int(round(0.02 / tm.timestep))
    # the JAX example's first control: split PRNGKey(0), uniform in [-1, 1]
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    ctrl = jax.random.uniform(sub, (jm.nu,), minval=-1.0, maxval=1.0)

    @jax.jit
    def chunk(state, ctrl):
        def body(s, _):
            s = jengine.step(jm, s, ctrl, max_contacts=12,
                             solver_iterations=4)
            return s, s.sensordata
        return jax.lax.scan(body, state, None, length=n)

    jst, jsens = chunk(jengine.make_state(jm, dtype=jnp.float64), ctrl)
    tst, tsens = rr.chunk(tm, make_state(tm, dtype=F64, device="cpu"),
                          torch.tensor(np.asarray(ctrl)), n)
    assert tsens.shape == (n, 33)
    np.testing.assert_allclose(tsens.numpy(), np.asarray(jsens), rtol=TOL,
                               atol=TOL)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)


def test_sweep_scoring_matches_jax_leg_engine():
    sweep = _load("examples", "torch_scenario_sweep")
    S, H, fs = 8, 1, 2
    jm, tm = jspec.get_planning_model(), tspec.get_planning_model()
    rng = np.random.default_rng(11)
    st = jengine.make_state(jm, dtype=jnp.float64)
    # a moving start (from rest v/|v| is ill-conditioned)
    st = st._replace(qvel=jnp.asarray(0.1 * rng.standard_normal(jm.nv)))
    seqs = np.clip(np.array(sweep.HOLD)
                   + 0.2 * rng.standard_normal((S, H, 12)), -1.0, 1.0)
    r = sweep.DP_RANGES

    def u(lo_hi):
        return rng.uniform(*lo_hi, S)

    dp = jspec.DomainParams(
        friction=u(r["friction_range"]), gain_scale=u(r["gain_range"]),
        base_mass_scale=u(r["mass_range"]), tilt_x=u(r["tilt_range"]),
        tilt_y=u(r["tilt_range"]), terrain_amp=u(r["terrain_amp_range"]),
        terrain_freq=u((15.0, 30.0)))
    cmd = jcommands.make(jnp.asarray([0.2, 0.0]), jnp.asarray(0.0))
    prev = np.array(sweep.HOLD)
    with jax.disable_jit():
        want = jrollout.lane_batched_rollout_cost(
            jm, jrollout.RolloutConfig(horizon=H, frame_skip=fs),
            jrollout.make_cost_fn(jm), st, jnp.asarray(seqs), cmd,
            jnp.asarray(prev), newton_iterations=sweep.BUDGET[0],
            ls_iterations=sweep.BUDGET[1], engine_impl="leg",
            dp=jspec.DomainParams(*(jnp.asarray(v) for v in dp)))
    got = sweep.score(
        tm, trollout.RolloutConfig(horizon=H, frame_skip=fs),
        convert.state(st, device="cpu"), torch.as_tensor(seqs),
        convert.command(cmd, device="cpu"), torch.as_tensor(prev),
        convert.domain_params(dp, device="cpu"))
    assert got.shape == (S,) and got.dtype == F64
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_sweep_main_on_the_cpu(capsys):
    out = _load("examples", "torch_scenario_sweep").main(
        6, device="cpu", seed=3, horizon=1)
    assert out["costs"].shape == (6,) and np.isfinite(out["costs"]).all()
    assert set(out["halves"]) == {"friction", "slope", "terrain"}
    printed = capsys.readouterr().out
    for line in ("scenario-rollouts/s", "cost: mean", "low-friction half",
                 "gentle-slope half", "smooth-terrain half"):
        assert line in printed


def test_roofline_bytes_are_the_jax_scripts():
    """``true_bytes`` against the JAX script's own lines (its ``nu``,
    ``state_bytes`` and ``true_bytes`` statements, executed on the JAX
    package's planning model)."""
    roof = _load("scripts", "torch_kernel_roofline")
    with open(os.path.join(REPO, "scripts", "kernel_roofline.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    stmts = [n for n in main.body if isinstance(n, ast.Assign)
             and isinstance(n.targets[0], ast.Name)
             and n.targets[0].id in ("nu", "state_bytes", "true_bytes")]
    assert [s.targets[0].id for s in stmts] == ["nu", "state_bytes",
                                                "true_bytes"]
    jm, tm = jspec.get_planning_model(), tspec.get_planning_model()
    for S in (1024, 65536):
        ns = {"m": jm, "S_ref": S, "H": roof.H}
        exec(compile(ast.Module(body=stmts, type_ignores=[]), "jax", "exec"),
             ns)
        assert roof.true_bytes(tm, S, roof.H) == ns["true_bytes"]


def test_kernel_roofline_main_on_the_cpu(tmp_path):
    """The script end to end at a toy size on the CPU (the plain version:
    times of the CPU, not of a card): its curve, its count held to
    ``rollout_flops``, its report and its trace."""
    out = str(tmp_path / "roofline.json")
    report = _load("scripts", "torch_kernel_roofline").main([
        "--cpu", "--samples", "2", "4", "--horizon", "1", "--reps", "1",
        "--seed", "0", "--trace", str(tmp_path / "trace"), "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert [r["samples"] for r in report["saturation_curve"]] == [2, 4]
    b = report["bounds_at_best"]
    assert b["operations_per_rollout"] == 332082.0  # PERF.md §6, 2/4
    assert b["true_hbm_bytes_per_solve"] == report["best"]["samples"] * (
        12 * 4 + 2 * 4 * (19 + 18 + 12 + 1 + 33) + 4)
    assert report["device"] == "cpu" and report["kernel"] == {}
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_closed_loop_walk_main_on_the_cpu(monkeypatch, capsys):
    """``main`` at 2 steps, its planner cut to 16 samples over H=3 (the
    full planner takes ~30 s a step on the CPU)."""
    walk = _load("examples", "torch_closed_loop_walk")
    cfg = walk.mpc_config()
    assert cfg.mppi.num_samples == 1024 and cfg.rollout.horizon == 20
    assert cfg.mppi.lane_engine_impl == "fused" and cfg.mppi.iterations == 2
    small = dataclasses.replace(cfg, mppi=dataclasses.replace(
        cfg.mppi, num_samples=16,
        rollout=dataclasses.replace(cfg.mppi.rollout, horizon=3)))
    monkeypatch.setattr(walk, "mpc_config", lambda: small)
    out = walk.main(2, 0.15, device="cpu", seed=0)
    assert out["ctrls"].shape == (2, 12) and out["sens"].shape == (2, 33)
    assert all(bool(torch.isfinite(out[k]).all())
               for k in ("ctrls", "sens", "costs"))
    assert out["phys"].qpos.device.type == "cpu"
    assert out["carry"].mean.shape == (3, 12)
    printed = capsys.readouterr().out
    for line in ("commanded +x 0.15 m/s; traveled", "uprightness min",
                 "body height"):
        assert line in printed


def test_latency_demo_on_the_cpu(tmp_path):
    demo = _load("examples", "torch_latency_demo")
    out = str(tmp_path / "latency.json")
    report = demo.main(["--cpu", "--samples", "8", "--horizon", "2",
                        "--measure-iters", "2", "--seconds", "0.5",
                        "--settle-steps", "5", "--out", out])
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(report))
    # the top-level keys of the JAX example's report (read from its
    # source), but for its tunnel estimate: here the host's launch and
    # synchronisation overhead
    with open(os.path.join(REPO, "examples", "latency_demo.py")) as f:
        tree = ast.parse(f.read())
    jax_report = next(
        n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
        and isinstance(n.targets[0], ast.Name)
        and n.targets[0].id == "report")
    jax_keys = {k.value for k in jax_report.keys}
    assert jax_keys - set(report) == {"tunnel_overhead_ms_estimate"}
    assert set(report) - jax_keys == {"launch_sync_overhead_ms_estimate"}
    assert set(report["two_process_loop"]) >= {
        "p50_ms", "p90_ms", "p99_ms", "mean_ms", "n", "periods",
        "deadline_misses", "deadline_ms", "plant_stdout"}
    assert report["sync_solve"]["n"] == 2
    assert report["pipelined_solve"]["k"] == 2
    assert report["two_process_loop"]["periods"] >= 1
    assert report["two_process_loop"]["plant_stdout"].startswith("plant: ")
    assert report["config"]["samples"] == 8
    assert not [n for n in os.listdir("/dev/shm")
                if n.startswith(f"qgt_torch_latency_{os.getpid()}")]


def test_eval_report_on_the_cpu(tmp_path):
    er = _load("scripts", "torch_eval_report")
    report = er.main(["--policy", POLICY, "--out", str(tmp_path),
                      "--seeds", "0", "--max-time", "0.04", "--cpu"])
    with open(tmp_path / "eval_report.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    sto, det = report["episodes"]
    assert (sto["mode"], det["mode"]) == ("stochastic", "deterministic")
    assert det["steps"] == 2
    net = evaluate.load_policy(POLICY, 260, "cpu")
    for row, deterministic in ((sto, False), (det, True)):
        em = evaluate.eval_rollout(net, obs_window=10, max_time=0.04,
                                   frame_skip=10,
                                   deterministic=deterministic, seed=0,
                                   device="cpu")
        assert row["episode_return"] == em["episode_return"]
    assert report["trained_iterations"] == checkpoint.read(POLICY)[1]
    assert report["stochastic_summary"]["episode_returns"] == [
        sto["episode_return"]]
    assert report["device"] == "cpu"


def test_export_policy_round_trip(tmp_path):
    run = str(tmp_path / "run")
    ts, _ = train.main(["--output", run, "--iterations", "1", "--num-envs",
                        "2", "--num-steps", "2", "--timesteps-per-iteration",
                        "4", "--frame-skip", "1", "--max-contacts", "4",
                        "--solver-iterations", "2", "--no-eval"],
                       device="cpu")
    out = str(tmp_path / "policy_params")
    _load("scripts", "torch_export_policy").main(
        ["--ckpt", os.path.join(run, "policy"), "--out", out, "--cpu"])
    arrays, step = checkpoint.read(out)
    want = ts.net.state_dict()
    assert step == 1 and len(arrays) == len(want)
    net = evaluate.load_policy(out, 260, "cpu")
    for got, w in zip(net.state_dict().values(), want.values()):
        assert got.dtype == w.dtype and torch.equal(got, w)


@pytest.mark.parametrize("folder,name,argv", [
    ("examples", "torch_random_rollout", []),
    ("examples", "torch_latency_demo", []),
    ("scripts", "torch_kernel_roofline", []),
    ("scripts", "torch_eval_report", ["--policy", POLICY, "--out", "x"]),
    ("scripts", "torch_export_policy", ["--ckpt", POLICY, "--out", "x"]),
    ("scripts", "torch_latency_parts", []),
    ("scripts", "torch_latency_report", []),
    ("scripts", "torch_latency_sweep", []),
    ("scripts", "torch_diag_gait", []),
    ("scripts", "torch_full_plant_budget_study", []),
])
def test_entry_points_need_the_card(folder, name, argv, tmp_path,
                                    monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(folder, name).main(argv)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("name,args", [
    ("torch_closed_loop_walk", (2,)),
    ("torch_scenario_sweep", (8,)),
])
def test_example_mains_need_the_card(name, args):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("examples", name).main(*args)
