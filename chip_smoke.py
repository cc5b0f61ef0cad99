#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases build,check  # build + kernel checks only

Phases, each of which raises on failure (nothing is caught):

1. device: the card's name and power limit (nvidia-smi).
2. build: every CUDA kernel from ``quadruped_gym_tpu_torch/ops/csrc``,
   all nvcc processes at once; build seconds, ptxas registers/spills, and
   for each main-path launch its block size, dynamic shared memory and
   the blocks the runtime says an SM holds.
3. check: each kernel against its plain PyTorch version on the card, on
   the same inputs, at the tolerances stated below: the fused rollout's
   costs, and the substep kernel's qpos, qvel, act and all 33 sensors;
   widths the block size does not divide included. A launch the card
   must refuse (too much shared memory) has to raise. The oracle engine
   (plain PyTorch, no kernel): ``physics.engine.step`` on the card
   against the CPU in float64 (a state in contact and one in the air,
   1e-9) on the plant model (``mpc_plant``) and on the gym env's
   (``full``, 24 contacts, the model's Newton budget), in float32 with
   the base far from the world origin against float64, and its float32
   products are true FP32 even while the process-wide TF32 flag is on.
4. main: the first slice's path at full bench width: ``init_carry`` and 3
   receding-horizon periods of MPPI ``plan_and_act`` (65,536 rollouts,
   H=50, frame_skip 5, fused kernel, Newton/line-search 2/4, float32) on
   the planning model, each followed by ``lane_control_step``; then one
   fused solve on the fast-plant model at 4/8.
5. plan: custom-cost planning through the substep kernel at the same
   width: 3 periods of MPPI ``plan_and_act`` with
   ``lane_engine_impl="pallas"`` and a stage cost the fused kernel
   refuses (``make_cost_fn(m, vel_smooth_eps=0.02)``), each followed by
   ``lane_control_step``; then one CEM ``plan_and_act`` (65,536 samples,
   64 elites, 3 iterations).
6. env: the batched walking env at the width PPO uses: 2,048 envs on the
   fast-plant model, partial observation over 10 frames, ``reset`` and 50
   ``batched_autoreset_step(engine_impl="pallas")`` under random actions.
7. loop: the closed loop at the width of the JAX package's
   ``examples/closed_loop_walk.py``: MPPI (1,024 samples, H=20, 2
   iterations, fused kernel) on the planning model driving the oracle
   engine on the ``mpc_plant`` model (feet, shins and ankle servos with
   full hulls) for 200 control steps of ``closed_loop`` under a 0.15 m/s
   forward command, float32. The walk must be finite, upright and go
   forward (limits at ``WALK_LIMITS``). Then 20 steps of
   ``delayed_closed_loop`` with the oracle plant and 20 with the
   leg-engine plant, the period's split into plan and plant, timed
   with a synchronise after each part, and one traced call of each
   (``torch.profiler``): the kernels the card ran and its idle share.
8. train: PPO at the trainer's defaults (2,048 envs x 32 steps, the
   ``mpc_plant`` model on the oracle engine at frame_skip 10, 12
   contacts, 4 Newton passes, partial observation over 10 frames,
   hidden (256, 256, 128), 4 epochs x 8 minibatches, float32) through
   ``rl.train.main``: 2 iterations of one update into a temporary
   directory, then a resume that continues at iteration 2 with one
   update and one fine-tune update (log_std <= -1.2). Metrics finite,
   32 CSV rows an update, the checkpoint's step after each call, the
   parameters on the card. Then one update timed in two parts (rollout,
   learning), a synchronise after each, one traced update
   (``torch.profiler``: kernels per env step, device time, idle share;
   its rollout cut to 2 env steps, which launch what every step does),
   one ``--lane-physics`` update cut to 2 env steps (the eager leg engine
   takes seconds an env step at this width), and the committed policy
   (``artifacts/walk_r5/policy_params``) on 2,048 of the run's
   observations: card float32 against CPU float64. Neither kernel runs
   on this path (as in the JAX package: the trainer's physics is the
   oracle engine or the eager leg engine).
9. eval: the trainer's per-iteration eval. The committed policy through
   ``rl.evaluate.eval_rollout`` on the card in float32
   (``POWalkingQuadrupedEnv`` on ``full``, obs window 10, frame_skip 10,
   24 contacts, the model's Newton budget), its 20 s episode cut to the
   JAX test's 0.6 s (30 control steps) and held to that test's limits;
   a control step timed after landing (host clock, synchronised) and one
   substep of its physics traced (``torch.profiler``: kernels, device
   time, idle share); the 20 s episode's cost extrapolated, beside the
   train phase's update; and ``rl.train.main`` at 2,048 envs with the eval on,
   cut to one update of 2 env steps and a 0.2 s eval episode, its
   ``logs/eval_metrics.jsonl`` row, plots and video checked. Neither
   kernel runs on this path (the gym env steps the oracle engine).
10. time: fused rollouts/s at S=65,536, H=50, float32 (synchronised per
   solve, 5 solves after a warm-up); the substep kernel's ``control_step``
   per launch at B=65,536 and B=2,048; each kernel's plain version and
   bound; B1's bound at the closed loop's shape; the custom-cost solve and
   the env's steps/s as phases 5 and 6 measured them.

Phases 4 to 9 each set the launch counters to 0 just before driving
their path and read them just after.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. With no CUDA device, or with any
failure, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

PHASES = ("device", "build", "check", "main", "plan", "env", "loop", "train",
          "eval", "time")
S_MAIN = 65536
H_MAIN = 50
FRAME_SKIP = 5
BUDGET = {"planning": (2, 4), "fast_plant": (4, 8)}
N_ENVS = 2048  # PPOConfig.num_envs of the JAX package
ENV_FRAME_SKIP = 4
# published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores in FLOP/s (an FMA counts two, as cuda_engine.count_ops counts it),
# HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
F64_TOL = 1e-8
# float32: ~6e-8 rounding per operation, amplified through the Newton
# contact solve over 5 substeps; a wrong kernel misses by far more
F32_TOL = 1e-4
ROLLOUT = "fused_rollout_cost"
SUBSTEP = "substep"
# the oracle engine on the card against the CPU, float64, one substep, on
# each model and engine options a path steps it with
ORACLE_F64_TOL = 1e-9
ORACLE_CASES = {"mpc_plant": dict(max_contacts=12, solver_iterations=4),
                "full": dict(max_contacts=24, solver_iterations=None)}
# the closed-loop walk: 200 control steps = 2 s of simulated time under a
# 0.15 m/s command. The JAX package's example typically travels ~0.32 m
# forward with < 3 cm of drift and uprightness > 0.98; the noise streams
# differ, so the limits are loose.
WALK_STEPS = 200
WALK_SPEED = 0.15
WALK_LIMITS = {"forward_m": 0.15, "sideways_m": 0.10, "upright": 0.9}
# the delayed loop, on each plant engine (cut from 20 steps: its lane
# plant takes ~5 s a period)
DELAYED_STEPS = 10
SPLIT_PERIODS = 5
# the train phase: rl.train.main's defaults, one update an iteration
TRAIN_ARGS = ["--timesteps-per-iteration", "65536", "--no-eval"]
LANE_TRAIN_STEPS = 2
# env steps of the traced rollout: a whole one (32 steps, 1.27M kernels)
# kept the profiler busy for ~10 minutes on the H100's host
TRACE_ENV_STEPS = 2
POLICY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "artifacts", "walk_r5", "policy_params")
# the network on the card in float32 against float64 on the CPU, relative
# to the largest output: FP32 rounding over 4 layers of <= 260 inputs is
# ~1e-6; TF32 products would miss by ~1e-3
POLICY_TOL = 1e-5
# the eval phase: the committed policy through rl.evaluate.eval_rollout on
# the gym env's model (full), cut from the trainer's 20 s episode to the
# JAX package's test episode (tests/test_walk_policy.py: 0.6 s, 30 control
# steps at frame_skip 10 in float64, 31 on a float32 clock) and held to
# that test's limits
EVAL_MAX_TIME = 0.6
EVAL_EPISODE_S = 20.0  # rl.train's --max-time: the episode it evals
EVAL_LIMITS = {"upright": 0.9, "tracking": 0.5}
EVAL_WARM_STEPS = 8
EVAL_TIMED_STEPS = 4
# rl.train.main at its defaults (2,048 envs), cut to one update of 2 env
# steps and an eval episode of 0.2 s (10 control steps)
EVAL_TRAIN_ARGS = ["--num-steps", "2", "--timesteps-per-iteration", "4096",
                   "--iterations", "1", "--max-time", "0.2"]
EVAL_KEYS = {"episode_return", "steps", "survived", "mean_tracking_error",
             "final_tracking_error", "mean_uprightness", "command_speed",
             "iteration"}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------------
# inputs


def start_state(m, kind: str, rng, dtype, device):
    """A shared start state near ``qpos0`` (perturbed so the base moves
    from the first substep), grounded or 0.5 m up."""
    from quadruped_gym_tpu_torch.physics.engine import State

    qpos = np.asarray(m.qpos0, np.float64) + 0.02 * rng.standard_normal(m.nq)
    if kind == "airborne":
        qpos[2] += 0.5
    qvel = 0.1 * rng.standard_normal(m.nv)
    act = np.array([0.0, 0.0, -0.5] * 4)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return State(qpos=t(qpos), qvel=t(qvel), act=t(act),
                 time=t(0.0), sensordata=t(np.zeros(m.nsensordata)))


def command(dtype, device, vx=0.2, vy=0.0, heading=0.0):
    from quadruped_gym_tpu_torch.tasks.commands import make

    return make(torch.tensor([vx, vy], dtype=dtype, device=device),
                torch.tensor(heading, dtype=dtype, device=device))


def prev_ctrl(dtype, device):
    return torch.tensor([0.0, 0.0, -0.5] * 4, dtype=dtype, device=device)


def random_seqs(gen, S, H, dtype, device, scale):
    prev = prev_ctrl(dtype, device)
    noise = torch.randn((S, H, 12), generator=gen, dtype=dtype, device=device)
    return torch.clamp(prev + scale * noise, -1.0, 1.0)


# --------------------------------------------------------------------------
# phases


def phase_device(rec):
    name = torch.cuda.get_device_name(0)
    rec["card"] = card_line()
    rec["kind"] = name
    log(f"device: {name} (count {torch.cuda.device_count()}); "
        f"nvidia-smi: {rec['card']}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")


def phase_build(rec):
    from quadruped_gym_tpu_torch.ops import _build

    sources = _build.kernel_sources()
    t0 = time.perf_counter()
    _build.build_all(sources, ("float32", "float64"))
    rec["build_s"] = time.perf_counter() - t0
    log(f"build: {rec['build_s']:.1f} s for float32 + float64 of "
        f"{', '.join(sources)} (nvcc in parallel)")
    for source in sources:
        for dtype in ("float32", "float64"):
            report = _build.ptxas_report(source, dtype)
            rec[f"ptxas_{source}_{dtype}"] = report
            log(f"ptxas {source} {dtype}:\n{report}")
    launch_report(rec)


def launch_report(rec):
    """Block size, grid and dynamic shared memory of every main-path
    launch, with the registers, local bytes and resident blocks per SM
    the CUDA runtime reports for the built kernel at that shape."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    f32 = torch.float32
    rec["launch"] = {}
    for label, source, model, n in (
            ("B1 planning", cuda_engine.KERNEL_SOURCE, "planning", S_MAIN),
            ("B1 fast_plant", cuda_engine.KERNEL_SOURCE, "fast_plant", S_MAIN),
            ("B2 planning", cuda_engine.SUBSTEP_SOURCE, "planning", S_MAIN),
            ("B2 fast_plant", cuda_engine.SUBSTEP_SOURCE, "fast_plant",
             S_MAIN),
            ("B2 env", cuda_engine.SUBSTEP_SOURCE, "fast_plant", N_ENVS)):
        m = getattr(spec, f"get_{model}_model")()
        nslot = cuda_engine.model_slots(m)
        geo = cuda_engine.launch_geometry(nslot, f32, n)
        info = cuda_engine.kernel_info(source, f32, geo.threads,
                                       geo.smem_bytes)
        info.update(grid=geo.grid, nslot=nslot, n=n)
        rec["launch"][label] = info
        log(f"launch {label}: n={n}, {nslot} slots a leg, float32: grid "
            f"{geo.grid} x {geo.threads} threads, {geo.smem_bytes} B dynamic "
            f"shared a block; {info['registers']} registers and "
            f"{info['local_bytes']} B local a thread; "
            f"{info['blocks_per_sm']} blocks = "
            f"{info['blocks_per_sm'] * geo.threads // 32} warps resident "
            f"per SM (CUDA occupancy API)")


def check_case(rec, label, model, kind, S, H, fs, budget, dtype, tol,
               dp_ranges=None, seed=0):
    """Kernel vs plain version on the card, on the same inputs."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev = torch.device("cuda")
    m = getattr(spec, f"get_{model}_model")()
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = start_state(m, kind, rng, dtype, dev)
    seqs = random_seqs(gen, S, H, dtype, dev, 0.3)
    cmd = command(dtype, dev, 0.2, 0.1, 0.3)
    prev = prev_ctrl(dtype, dev)
    dp = None
    if dp_ranges is not None:
        dp = spec.sample_domain_params(gen, S, dtype=dtype, **dp_ranges)
    it, lsi = budget
    got = cuda_engine.fused_rollout_cost(m, state, seqs, cmd, prev, fs, it,
                                         lsi, dp=dp)
    torch.cuda.synchronize()
    ref = cuda_engine.fused_rollout_cost_reference(m, state, seqs, cmd, prev,
                                                   fs, it, lsi, dp=dp)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{label}: non-finite kernel costs")
    err = (got - ref).abs()
    bad = err > tol + tol * ref.abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
    log(f"check {label}: S={S} H={H} frame_skip={fs} budget {it}/{lsi} "
        f"{dtype}: max_abs_err {max_abs:.3e} max_rel_err {max_rel:.3e} "
        f"(rtol=atol={tol:g}); {int(bad.sum())} of {S} outside; "
        f"card: {rec['card']}")
    if bool(bad.any()):
        raise AssertionError(f"{label}: kernel disagrees with the plain "
                             f"version ({int(bad.sum())} rollouts)")
    rec.setdefault("checks", {})[label] = {"max_abs_err": max_abs,
                                           "max_rel_err": max_rel}
    return max_abs


def lane_inputs(m, kind, B, rng, dtype, device):
    """A batch-minor ``LaneState`` of B lanes near ``qpos0``, each lane
    perturbed on its own and moving, grounded or 0.5 m up, and (12, B)
    controls."""
    from quadruped_gym_tpu_torch.ops.lane_engine import LaneState

    qpos = (np.asarray(m.qpos0, np.float64)[:, None]
            + 0.02 * rng.standard_normal((m.nq, B)))
    if kind == "airborne":
        qpos[2] += 0.5
    qvel = 0.1 * rng.standard_normal((m.nv, B))
    act = np.tile(np.array([0.0, 0.0, -0.5] * 4)[:, None], (1, B))
    ctrl = np.clip(act + 0.3 * rng.standard_normal((m.nu, B)), -1.0, 1.0)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    ls = LaneState(qpos=t(qpos), qvel=t(qvel), act=t(act),
                   time=t(0.002 * np.arange(B)),
                   sensordata=t(np.ones((m.nsensordata, B))))
    return ls, t(ctrl)


def check_substep(rec, label, model, kind, B, nsub, budget, dtype, tol,
                  dp_ranges=None, seed=0, single_step=False, sensors=True):
    """The substep kernel vs its plain version on the card, on the same
    inputs: qpos, qvel, act, time and every sensor."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev = torch.device("cuda")
    m = getattr(spec, f"get_{model}_model")()
    ls, ctrl = lane_inputs(m, kind, B, np.random.default_rng(seed), dtype,
                           dev)
    dp = None
    if dp_ranges is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dp = spec.sample_domain_params(gen, B, dtype=dtype, **dp_ranges)
    it, lsi = budget
    if single_step:
        got = cuda_engine.step(m, ls, ctrl, it, lsi, dp=dp,
                               compute_sensors=sensors)
        torch.cuda.synchronize()
        ref = cuda_engine.step_reference(m, ls, ctrl, it, lsi, dp=dp,
                                         compute_sensors=sensors)
    else:
        got = cuda_engine.control_step(m, ls, ctrl, nsub, it, lsi, dp=dp)
        torch.cuda.synchronize()
        ref = cuda_engine.control_step_reference(m, ls, ctrl, nsub, it, lsi,
                                                 dp=dp)
    torch.cuda.synchronize()
    errs, n_bad = {}, 0
    for f in got._fields:
        g, r = getattr(got, f), getattr(ref, f)
        if g.shape != r.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{label}: {f} has a wrong shape or is "
                                 "not finite")
        err = (g - r).abs()
        n_bad += int((err > tol + tol * r.abs()).sum())
        errs[f] = float(err.max())
    if not sensors and float(got.sensordata.abs().max()) != 0.0:
        raise AssertionError(f"{label}: sensordata must be zeros")
    if sensors and float(got.sensordata.abs().min(dim=1).values.max()) == 0.0:
        raise AssertionError(f"{label}: a sensor row was left unwritten")
    what = "step" if single_step else f"control_step frame_skip={nsub}"
    log(f"check substep {label}: B={B} {what} sensors={sensors} budget "
        f"{it}/{lsi} {dtype}: max_abs_err "
        + " ".join(f"{f} {e:.3e}" for f, e in errs.items())
        + f" (rtol=atol={tol:g}); {n_bad} values outside; "
        f"card: {rec['card']}")
    if n_bad:
        raise AssertionError(f"{label}: the substep kernel disagrees with "
                             f"its plain version ({n_bad} values)")
    rec.setdefault("checks", {})[f"substep {label}"] = errs
    return max(errs.values())


def phase_check(rec):
    f64, f32 = torch.float64, torch.float32
    dp = dict(friction_range=(0.4, 0.8), gain_range=(0.8, 1.2),
              mass_range=(0.9, 1.5), tilt_range=(-0.1, 0.1),
              terrain_amp_range=(0.0, 0.02))
    check_case(rec, "f64 planning grounded", "planning", "grounded",
               4096, 1, 5, (4, 8), f64, F64_TOL, seed=1)
    check_case(rec, "f64 planning airborne", "planning", "airborne",
               4096, 3, 2, (4, 8), f64, F64_TOL, seed=2)
    check_case(rec, "f64 planning DomainParams", "planning", "grounded",
               4096, 1, 3, (4, 8), f64, F64_TOL, dp_ranges=dp, seed=3)
    check_case(rec, "f64 fast_plant grounded", "fast_plant", "grounded",
               4096, 1, 5, (4, 8), f64, F64_TOL, seed=4)
    # S that no block size divides: the last block's spare quads run on a
    # clamped rollout and must store nothing
    check_case(rec, "f64 planning ragged S", "planning", "grounded",
               4001, 2, 2, (4, 8), f64, F64_TOL, seed=7)
    # the main path's width, type and budget; H cut to one control step
    # because grounded rollouts diverge chaotically across bit-different
    # programs over longer horizons
    # the closed loop's planner launches the same kernel at its own width
    # and budget (fewer blocks than the card has SMs): taken from the
    # loop's configuration so the two cannot drift apart
    walk = walk_config().mppi
    rec["max_abs_err_main_shape"] = max(
        check_case(rec, "f32 planning grounded (main-path width)",
                   "planning", "grounded", S_MAIN, 1, FRAME_SKIP,
                   BUDGET["planning"], f32, F32_TOL, seed=5),
        check_case(rec, "f32 fast_plant grounded (main-path width)",
                   "fast_plant", "grounded", S_MAIN, 1, FRAME_SKIP,
                   BUDGET["fast_plant"], f32, F32_TOL, seed=6),
        check_case(rec, "f32 planning grounded (loop width)",
                   "planning", "grounded", walk.num_samples, 1,
                   walk.rollout.frame_skip,
                   (walk.lane_newton_iterations, walk.lane_ls_iterations),
                   f32, F32_TOL, seed=8),
        check_case(rec, "f32 planning airborne (loop width and horizon)",
                   "planning", "airborne", walk.num_samples,
                   walk.rollout.horizon, walk.rollout.frame_skip,
                   (walk.lane_newton_iterations, walk.lane_ls_iterations),
                   f32, F32_TOL, seed=9),
    )
    # the substep kernel: float64 at B around 4,096 (one B that 128 does
    # not divide), then float32 at the widths of its two main paths
    check_substep(rec, "f64 planning grounded", "planning", "grounded",
                  4096, 1, (4, 8), f64, F64_TOL, seed=11, single_step=True)
    check_substep(rec, "f64 planning airborne", "planning", "airborne",
                  4000, 3, (4, 8), f64, F64_TOL, seed=12)
    check_substep(rec, "f64 planning DomainParams", "planning", "grounded",
                  4096, 3, (4, 8), f64, F64_TOL, dp_ranges=dp, seed=13)
    check_substep(rec, "f64 fast_plant grounded", "fast_plant", "grounded",
                  4096, 5, (4, 8), f64, F64_TOL, seed=14)
    check_substep(rec, "f64 planning no sensors", "planning", "grounded",
                  1000, 1, (4, 8), f64, F64_TOL, seed=15, single_step=True,
                  sensors=False)
    rec["substep_max_abs_err_main_shape"] = max(
        check_substep(rec, "f32 planning grounded (planning width)",
                      "planning", "grounded", S_MAIN, FRAME_SKIP,
                      BUDGET["planning"], f32, F32_TOL, seed=16),
        check_substep(rec, "f32 fast_plant grounded (planning width)",
                      "fast_plant", "grounded", S_MAIN, FRAME_SKIP,
                      BUDGET["fast_plant"], f32, F32_TOL, seed=17),
        check_substep(rec, "f32 fast_plant grounded (env width)",
                      "fast_plant", "grounded", N_ENVS, ENV_FRAME_SKIP,
                      BUDGET["fast_plant"], f32, F32_TOL, seed=18),
    )
    check_refused_launch(rec)
    check_oracle(rec)


def oracle_states(m, dtype, device, **kw):
    """Two start states of the oracle engine and a control, made on the
    CPU in float64 from a seed: the robot on its feet and moving (the
    reset state hangs 10 cm above the floor, so it is dropped for 0.4 s
    first, under the engine options ``kw``), and in the air, tilted, 6 m
    up and 50 m from the world origin."""
    from quadruped_gym_tpu_torch.physics import engine

    rng = np.random.default_rng(20)
    f64 = torch.float64
    centers = torch.tensor([0.0, 0.0, -0.5] * 4, dtype=f64)
    st = engine.make_state(m, dtype=f64, device="cpu")
    st = engine.control_step(m, st, centers, 200, **kw)
    contact = st._replace(
        qvel=st.qvel + 0.2 * torch.as_tensor(rng.standard_normal(m.nv)))
    qpos = st.qpos.clone()
    qpos[:3] = torch.tensor([40.0, -30.0, 6.0], dtype=f64)
    quat = rng.standard_normal(4)
    qpos[3:7] = torch.as_tensor(quat / np.linalg.norm(quat))
    qpos[7:] += 0.2 * torch.as_tensor(rng.standard_normal(m.nq - 7))
    airborne = st._replace(
        qpos=qpos, qvel=torch.as_tensor(0.5 * rng.standard_normal(m.nv)))
    ctrl = torch.as_tensor(rng.uniform(-1.0, 1.0, m.nu))

    def to(x):
        return type(x)(*(v.to(device=device, dtype=dtype) for v in x))

    return {"contact": to(contact), "airborne": to(airborne)}, ctrl.to(
        device=device, dtype=dtype)


def check_oracle(rec):
    """The oracle engine is plain PyTorch: the card must compute what the
    CPU computes (float64), stay accurate in float32 far from the world
    origin, and never drop to TF32. Float64 on both of its paths' models
    and options: the closed loop's and the trainer's plant (``mpc_plant``,
    12 contacts, 4 Newton passes) and the gym env's (``full``: 25 geoms,
    24 contacts, the model's Newton budget)."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.physics import engine, maths

    dev = torch.device("cuda")
    f64, f32 = torch.float64, torch.float32
    errs, cases = {}, {}
    for name, kw in ORACLE_CASES.items():
        m = spec.get_snapshot(name)
        on_cpu, ctrl_cpu = cases[name] = oracle_states(m, f64, "cpu", **kw)
        for kind, st in on_cpu.items():
            want = engine.step(m, st, ctrl_cpu, **kw)
            ncon = int(engine.forward(m, st, ctrl_cpu, **kw).ncon_active)
            if (ncon > 0) != (kind == "contact"):
                raise AssertionError(f"oracle {name} {kind}: {ncon} active "
                                     "rows")
            got = engine.step(m, type(st)(*(v.to(dev) for v in st)),
                              ctrl_cpu.to(dev), **kw)
            for f in got._fields:
                g, w = getattr(got, f).cpu(), getattr(want, f)
                if g.dtype != f64 or not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"oracle {name} {kind}: {f} not "
                                         "finite float64")
                err = (g - w).abs()
                if bool((err > ORACLE_F64_TOL
                         + ORACLE_F64_TOL * w.abs()).any()):
                    raise AssertionError(
                        f"oracle {name} {kind}: {f} on the card differs from "
                        f"the CPU by {float(err.max()):.3e}")
                errs[f"{name} {kind} {f}"] = float(err.max())
            log(f"check oracle engine.step f64 {name} {kw} {kind} ({ncon} "
                "active rows): card vs CPU max_abs_err "
                + " ".join(f"{f} {errs[f'{name} {kind} {f}']:.2e}"
                           for f in got._fields)
                + f" (rtol=atol={ORACLE_F64_TOL:g})")
    # float32 and TF32 on the plant of the closed loop and the trainer
    m, kw = spec.get_mpc_plant_model(), ORACLE_CASES["mpc_plant"]
    on_cpu, ctrl_cpu = cases["mpc_plant"]

    # float32, 6 m up and 50 m out, against float64 on the card: spatial
    # vectors are measured from the base, so float32 rounding (6e-8 of
    # values near 1) is all there is; measured from the world origin the
    # mass matrix alone would be off by ~m|p|^2 * 6e-8 ~ 1e-4 of 2500.
    st64 = type(on_cpu["airborne"])(*(v.to(dev) for v in on_cpu["airborne"]))
    want = engine.step(m, st64, ctrl_cpu.to(dev), **kw)
    st32 = type(st64)(*(v.to(f32) for v in st64))
    ctrl32 = ctrl_cpu.to(device=dev, dtype=f32)
    got = engine.step(m, st32, ctrl32, **kw)
    acc = slice(m.sensor_adr("body_accel"), m.sensor_adr("body_accel") + 3)
    far = {"qvel": (got.qvel, want.qvel, 5e-4),
           "qpos": (got.qpos, want.qpos, 1e-5),
           "body_accel": (got.sensordata[acc], want.sensordata[acc], 5e-3)}
    for name, (g, w, tol) in far.items():
        if g.dtype != f32:
            raise AssertionError(f"oracle f32: {name} is {g.dtype}")
        err = float((g.double() - w).abs().max())
        errs[f"f32 far {name}"] = err
        if not err <= tol * (1.0 + float(w.abs().max())):
            raise AssertionError(f"oracle f32 far from the origin: {name} "
                                 f"off by {err:.3e} (tolerance {tol:g})")
    log("check oracle engine.step f32 at (40, -30, 6) m vs f64: max_abs_err "
        + " ".join(f"{k} {errs[f'f32 far {k}']:.2e} (tol {far[k][2]:g} "
                   "relative to 1 + max|x|)" for k in far))

    # true FP32 whatever the process-wide flag says: with the flag ON a
    # bare matmul is TF32 (logged, to show the flag bites on this card),
    # inside the engine's context it is FP32, and a whole step is the
    # same in every bit with the flag on and off
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    a = torch.randn((512, 512), generator=gen, device=dev, dtype=f32)
    b = torch.randn((512, 512), generator=gen, device=dev, dtype=f32)
    ref = a.double() @ b.double()
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        bare = float(((a @ b).double() - ref).abs().max() / ref.abs().max())
        with maths.true_fp32():
            kept = float(((a @ b).double() - ref).abs().max()
                         / ref.abs().max())
        flagged = engine.step(m, st32, ctrl32, **kw)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    same = all(bool(torch.equal(x, y)) for x, y in zip(flagged, got))
    log(f"check oracle true FP32: with allow_tf32=True a bare 512x512 "
        f"matmul is off by {bare:.2e} of max|ref|, inside maths.true_fp32() "
        f"by {kept:.2e}; engine.step with the flag on equals the flag off "
        f"in every bit: {same}")
    if not kept < 1e-6:
        raise AssertionError(f"float32 matmul inside true_fp32() is off by "
                             f"{kept:.2e}: not FP32")
    if not same:
        raise AssertionError("engine.step changes with allow_tf32: its "
                             "float32 products are not pinned to FP32")
    rec["oracle_check"] = dict(errs, tf32_bare_rel_err=bare,
                               fp32_kept_rel_err=kept)


def check_refused_launch(rec):
    """A launch the card refuses must raise in Python, and the next good
    launch must work: ask for more dynamic shared memory than a block may
    have, through the wrapper's private launch function."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    ls, ctrl = lane_inputs(m, "grounded", 256, np.random.default_rng(19), dt,
                           dev)
    too_much = cuda_engine.LaunchGeometry(8, 128, 300 * 1024)
    before = dict(cuda_engine.launch_counts)
    try:
        cuda_engine._launch_substeps(m, ls, ctrl, 1, 2, 4, None, True,
                                     geometry=too_much)
    except RuntimeError as e:
        log(f"check refused launch: raised as it must: {e}")
    else:
        raise AssertionError("a launch with 300 KB of dynamic shared memory "
                             "did not raise")
    if cuda_engine.launch_counts != before:
        raise AssertionError("a refused launch was counted")
    out = cuda_engine.step(m, ls, ctrl, 2, 4)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.qpos).all()):
        raise AssertionError("the launch after a refused one failed")
    rec["refused_launch_raises"] = True


def mpc_config(model: str):
    from quadruped_gym_tpu_torch.runtime.mpc_runtime import MPCConfig
    from quadruped_gym_tpu_torch.solvers.mppi import MPPIConfig
    from quadruped_gym_tpu_torch.solvers.rollout import RolloutConfig

    it, lsi = BUDGET[model]
    return MPCConfig(solver="mppi", mppi=MPPIConfig(
        num_samples=S_MAIN,
        rollout=RolloutConfig(horizon=H_MAIN, frame_skip=FRAME_SKIP),
        lane=True, lane_engine_impl="fused",
        lane_newton_iterations=it, lane_ls_iterations=lsi))


def phase_main(rec, periods=3):
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.runtime import mpc_runtime
    from quadruped_gym_tpu_torch.solvers.rollout import make_cost_fn

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    cfg = mpc_config("planning")
    cost_fn = make_cost_fn(m)
    carry = mpc_runtime.init_carry(m, cfg, H_MAIN, seed=0, dtype=dt,
                                   device=dev)
    phys = make_state(m, dtype=dt, device=dev)
    cmd = command(dt, dev)
    lo = torch.as_tensor(m.actuator_ctrlrange[:, 0], dtype=dt, device=dev)
    hi = torch.as_tensor(m.actuator_ctrlrange[:, 1], dtype=dt, device=dev)

    plan_s, step_s = [], []
    cuda_engine.reset_launch_counts()
    t0 = time.perf_counter()
    for p in range(periods):
        t1 = time.perf_counter()
        ctrl, carry, info = mpc_runtime.plan_and_act(m, cfg, cost_fn, carry,
                                                     phys, cmd)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        phys = mpc_runtime.lane_control_step(m, phys, ctrl,
                                             cfg.plant_frame_skip)
        torch.cuda.synchronize()
        plan_s.append(t2 - t1)
        step_s.append(time.perf_counter() - t2)
        vals = [info["best_cost"], info["mean_cost"], carry.mean, ctrl,
                phys.qpos, phys.qvel, phys.act, phys.sensordata]
        if not all(bool(torch.isfinite(v).all()) for v in vals):
            raise AssertionError(f"period {p}: non-finite cost/plan/state")
        if not bool(((ctrl >= lo) & (ctrl <= hi)).all()):
            raise AssertionError(f"period {p}: ctrl outside ctrlrange")
        log(f"main period {p}: best_cost {float(info['best_cost']):.4f} "
            f"mean_cost {float(info['mean_cost']):.4f} "
            f"base z {float(phys.qpos[2]):.4f}; plan_and_act "
            f"{plan_s[-1]:.4f} s, lane_control_step {step_s[-1]:.4f} s "
            f"(host clock, synchronised)")
    planning_launches = cuda_engine.launch_counts[ROLLOUT]
    substep_launches = cuda_engine.launch_counts[SUBSTEP]
    rec["main_s"] = time.perf_counter() - t0
    rec["plan_s"], rec["lane_control_step_s"] = plan_s, step_s
    if planning_launches != periods:
        raise AssertionError(f"fused kernel launched {planning_launches} "
                             f"times in {periods} periods")

    fp = spec.get_fast_plant_model()
    fcfg = mpc_config("fast_plant")
    fcarry = mpc_runtime.init_carry(fp, fcfg, H_MAIN, seed=1, dtype=dt,
                                    device=dev)
    fphys = make_state(fp, dtype=dt, device=dev)
    cuda_engine.reset_launch_counts()
    ctrl, fcarry, info = mpc_runtime.plan_and_act(
        fp, fcfg, make_cost_fn(fp), fcarry, fphys, cmd)
    torch.cuda.synchronize()
    fast_launches = cuda_engine.launch_counts[ROLLOUT]
    substep_launches += cuda_engine.launch_counts[SUBSTEP]
    if substep_launches != 0:
        raise AssertionError(f"the fused path launched the substep kernel "
                             f"{substep_launches} times")
    if fast_launches != 1:
        raise AssertionError(f"fast-plant solve launched the kernel "
                             f"{fast_launches} times")
    if not (bool(torch.isfinite(info["best_cost"]))
            and bool(torch.isfinite(fcarry.mean).all())):
        raise AssertionError("fast-plant solve: non-finite cost or plan")
    log(f"main fast_plant solve: best_cost {float(info['best_cost']):.4f}")
    counts = rec.setdefault("launches", {})
    counts[ROLLOUT] = (counts.get(ROLLOUT, 0) + planning_launches
                       + fast_launches)
    log(f"main: fused_rollout_cost launches {planning_launches} "
        f"(planning, {periods} periods) + {fast_launches} (fast plant); "
        f"{rec['main_s']:.2f} s for the planning periods "
        f"({sum(plan_s):.2f} s in plan_and_act, {sum(step_s):.2f} s in "
        f"lane_control_step)")


def planning_config(solver: str):
    """The custom-cost planner: per-control-step scoring through the
    substep kernel at the main path's width and budget."""
    from quadruped_gym_tpu_torch.runtime.mpc_runtime import MPCConfig
    from quadruped_gym_tpu_torch.solvers.cem import CEMConfig
    from quadruped_gym_tpu_torch.solvers.mppi import MPPIConfig
    from quadruped_gym_tpu_torch.solvers.rollout import RolloutConfig

    it, lsi = BUDGET["planning"]
    common = dict(num_samples=S_MAIN, lane=True, lane_engine_impl="pallas",
                  rollout=RolloutConfig(horizon=H_MAIN,
                                        frame_skip=FRAME_SKIP),
                  lane_newton_iterations=it, lane_ls_iterations=lsi)
    return MPCConfig(solver=solver, mppi=MPPIConfig(**common),
                     cem=CEMConfig(num_elites=64, iterations=3, **common))


def phase_plan(rec, periods=3):
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.runtime import mpc_runtime
    from quadruped_gym_tpu_torch.solvers.rollout import make_cost_fn

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_planning_model()
    cost_fn = make_cost_fn(m, vel_smooth_eps=0.02)
    if cost_fn._is_walking_stage_cost:
        raise AssertionError("the smoothed cost must not pass for the "
                             "fused kernel's")
    cmd = command(dt, dev)
    lo = torch.as_tensor(m.actuator_ctrlrange[:, 0], dtype=dt, device=dev)
    hi = torch.as_tensor(m.actuator_ctrlrange[:, 1], dtype=dt, device=dev)

    def checked(tag, ctrl, carry, info, phys):
        vals = [info["best_cost"], info["mean_cost"], carry.mean, carry.sigma,
                ctrl, phys.qpos, phys.qvel, phys.act, phys.sensordata]
        if not all(bool(torch.isfinite(v).all()) for v in vals):
            raise AssertionError(f"{tag}: non-finite cost/plan/state")
        if not bool(((ctrl >= lo) & (ctrl <= hi)).all()):
            raise AssertionError(f"{tag}: ctrl outside ctrlrange")

    cfg = planning_config("mppi")
    carry = mpc_runtime.init_carry(m, cfg, H_MAIN, seed=2, dtype=dt,
                                   device=dev)
    phys = make_state(m, dtype=dt, device=dev)
    plan_s, step_s = [], []
    cuda_engine.reset_launch_counts()
    for p in range(periods):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ctrl, carry, info = mpc_runtime.plan_and_act(m, cfg, cost_fn, carry,
                                                     phys, cmd)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        phys = mpc_runtime.lane_control_step(m, phys, ctrl,
                                             cfg.plant_frame_skip)
        torch.cuda.synchronize()
        plan_s.append(t2 - t1)
        step_s.append(time.perf_counter() - t2)
        checked(f"plan period {p}", ctrl, carry, info, phys)
        log(f"plan period {p} (MPPI, custom cost): best_cost "
            f"{float(info['best_cost']):.4f} mean_cost "
            f"{float(info['mean_cost']):.4f} base z {float(phys.qpos[2]):.4f};"
            f" plan_and_act {plan_s[-1]:.4f} s, lane_control_step "
            f"{step_s[-1]:.4f} s (host clock, synchronised)")
    mppi_launches = cuda_engine.launch_counts[SUBSTEP]
    fused = cuda_engine.launch_counts[ROLLOUT]
    if mppi_launches != periods * H_MAIN or fused != 0:
        raise AssertionError(
            f"custom-cost MPPI: {mppi_launches} substep launches in "
            f"{periods} periods of H={H_MAIN} (want {periods * H_MAIN}), "
            f"{fused} fused launches (want 0)")

    ccfg = planning_config("cem")
    ccarry = mpc_runtime.init_carry(m, ccfg, H_MAIN, seed=3, dtype=dt,
                                    device=dev)
    cuda_engine.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    ctrl, ccarry2, info = mpc_runtime.plan_and_act(m, ccfg, cost_fn, ccarry,
                                                   phys, cmd)
    torch.cuda.synchronize()
    cem_s = time.perf_counter() - t1
    cem_launches = cuda_engine.launch_counts[SUBSTEP]
    fused = cuda_engine.launch_counts[ROLLOUT]
    checked("CEM solve", ctrl, ccarry2, info, phys)
    want = ccfg.cem.iterations * H_MAIN
    if cem_launches != want or fused != 0:
        raise AssertionError(f"CEM: {cem_launches} substep launches (want "
                             f"{want}), {fused} fused launches (want 0)")
    if not float(ccarry2.sigma.mean()) < float(ccarry.sigma.mean()):
        raise AssertionError("CEM did not narrow its distribution")
    log(f"plan CEM solve ({ccfg.cem.num_samples} samples, "
        f"{ccfg.cem.num_elites} elites, {ccfg.cem.iterations} iterations): "
        f"best_cost {float(info['best_cost']):.4f} mean_cost "
        f"{float(info['mean_cost']):.4f} mean sigma "
        f"{float(ccarry2.sigma.mean()):.4f}; {cem_s:.4f} s")
    rec["custom_plan_s"], rec["custom_lane_control_step_s"] = plan_s, step_s
    rec["cem_solve_s"] = cem_s
    launches = rec.setdefault("launches", {})
    launches[SUBSTEP] = launches.get(SUBSTEP, 0) + mppi_launches + cem_launches
    log(f"plan: substep launches {mppi_launches} (MPPI, {periods} periods x "
        f"H={H_MAIN}) + {cem_launches} (CEM, {ccfg.cem.iterations} "
        f"iterations x H={H_MAIN}); fused_rollout_cost launches 0")


def phase_env(rec, steps=50, warm=10):
    from quadruped_gym_tpu_torch.envs.vector_env import VectorWalkingEnv
    from quadruped_gym_tpu_torch.envs.vector_env import batched_autoreset_step
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.tasks import walking

    dev, dt = torch.device("cuda"), torch.float32
    m = spec.get_fast_plant_model()
    # max_time is cut from 10 s so that every episode ends inside the run
    # and the auto-reset branch is taken on the card too
    cfg = walking.WalkingConfig(max_time=0.3, frame_skip=ENV_FRAME_SKIP,
                                partial_obs=True, obs_window=10,
                                random_controls=True, random_init=True,
                                dtype=dt)
    env = VectorWalkingEnv(m, cfg, N_ENVS, lane_physics=True, seed=4)
    state, obs = env.reset()
    if obs.device.type != dev.type or obs.shape != (N_ENVS, 260):
        raise AssertionError(f"reset obs {tuple(obs.shape)} on {obs.device}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    n_done = torch.zeros((), dtype=torch.int64, device=dev)
    cuda_engine.reset_launch_counts()
    t0 = None
    for k in range(steps):
        if k == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        action = walking.clip_ctrl(m, 0.5 * torch.randn(
            (N_ENVS, m.nu), generator=gen, dtype=dt, device=dev))
        out = batched_autoreset_step(m, cfg, state, action, env.generator,
                                     engine_impl="pallas")
        want_time = state.phys.time
        for _ in range(cfg.frame_skip):
            want_time = want_time + m.timestep
        late = (~out.done) & (out.state.phys.time != want_time)
        fresh = out.done & (out.state.phys.time != 0.0)
        for x in (out.obs, out.reward, out.reward_components,
                  out.state.phys.qpos, out.state.phys.qvel):
            bad = bad + (~torch.isfinite(x)).sum()
        bad = bad + late.sum() + fresh.sum()
        n_done = n_done + out.done.sum()
        state = out.state
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = cuda_engine.launch_counts[SUBSTEP]
    if (out.obs.shape != (N_ENVS, 260) or out.reward.shape != (N_ENVS,)
            or out.reward_components.shape != (N_ENVS, 11)
            or out.done.dtype != torch.bool or out.obs.dtype != dt):
        raise AssertionError("env step: wrong output shapes or types")
    if int(bad) != 0:
        raise AssertionError(f"env: {int(bad)} non-finite values or lanes "
                             "whose time did not advance by a control step")
    if int(n_done) == 0:
        raise AssertionError("env: no episode ended, auto-reset not driven")
    if launches != steps or cuda_engine.launch_counts[ROLLOUT] != 0:
        raise AssertionError(f"env: {launches} substep launches in {steps} "
                             "steps")
    rec["env_steps_per_s"] = N_ENVS * (steps - warm) / elapsed
    rec["env_step_ms"] = 1e3 * elapsed / (steps - warm)
    counts = rec.setdefault("launches", {})
    counts[SUBSTEP] = counts.get(SUBSTEP, 0) + launches
    log(f"env: {N_ENVS} envs x {steps} batched_autoreset_step (fast plant, "
        f"frame_skip {cfg.frame_skip}, PO window {cfg.obs_window}, float32): "
        f"obs {tuple(out.obs.shape)}, mean reward "
        f"{float(out.reward.mean()):.3f}, {int(n_done)} resets, mean base z "
        f"{float(out.state.phys.qpos[:, 2].mean()):.4f}; substep launches "
        f"{launches}; {rec['env_steps_per_s']:.1f} env-steps/s, "
        f"{rec['env_step_ms']:.3f} ms per step over the last "
        f"{steps - warm} steps (host clock, one synchronise at the end); "
        f"card: {rec['card']}")


def walk_config():
    """The planner and plant budgets of the JAX package's
    ``examples/closed_loop_walk.py``."""
    from quadruped_gym_tpu_torch.runtime.mpc_runtime import MPCConfig
    from quadruped_gym_tpu_torch.solvers.mppi import MPPIConfig
    from quadruped_gym_tpu_torch.solvers.rollout import RolloutConfig

    return MPCConfig(
        solver="mppi",
        mppi=MPPIConfig(
            num_samples=1024, sigma=0.25, temperature=0.5, iterations=2,
            lane=True, lane_engine_impl="fused",
            rollout=RolloutConfig(horizon=20, frame_skip=5)),
        plant_frame_skip=5, plant_max_contacts=12, plant_solver_iterations=4)


def walk_setup(device, seed):
    """(planning model, plant model, config, cost, command, carry, state)
    of the closed-loop walk on ``device``, float32."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.physics.engine import make_state
    from quadruped_gym_tpu_torch.runtime import mpc_runtime
    from quadruped_gym_tpu_torch.solvers.rollout import make_cost_fn

    dt = torch.float32
    pm, plant = spec.get_planning_model(), spec.get_mpc_plant_model()
    cfg = walk_config()
    cmd = command(dt, device, WALK_SPEED, 0.0, 0.0)
    carry = mpc_runtime.init_carry(pm, cfg, cfg.rollout.horizon, seed=seed,
                                   dtype=dt, device=device)
    phys = make_state(plant, dtype=dt, device=device)
    return pm, plant, cfg, make_cost_fn(pm), cmd, carry, phys


def walk_summary(pm, ctrls, sens, costs, n_steps, wall_s):
    """The example's five summary lines and the numbers the limits read;
    raises unless the walk is finite, upright and went forward."""
    from quadruped_gym_tpu_torch.tasks.rewards import SensorSlices

    for name, x in (("controls", ctrls), ("sensors", sens),
                    ("costs", costs)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"walk: non-finite {name}")
    sl = SensorSlices.from_model(pm)
    sens = sens.double().cpu().numpy()
    pos = sens[:, sl.pos:sl.pos + 3]
    vel = sens[:, sl.vel:sl.vel + 2]
    z = sens[:, sl.zaxis + 2]
    warm = n_steps // 4
    out = {"steps": n_steps, "wall_s": wall_s,
           "forward_m": float(pos[-1][0]), "sideways_m": float(pos[-1][1]),
           "mean_vx": float(vel[warm:, 0].mean()),
           "mean_abs_vy": float(np.abs(vel[warm:, 1]).mean()),
           "upright_min": float(z.min()),
           "height_min": float(pos[:, 2].min()),
           "height_max": float(pos[:, 2].max())}
    log(f"walk: done in {wall_s:.1f} s wall ({n_steps} control steps, "
        f"{n_steps * 5 * pm.timestep:.1f} s simulated)")
    log(f"walk: commanded +x {WALK_SPEED} m/s; traveled "
        f"({out['forward_m']:+.3f}, {out['sideways_m']:+.3f}) m")
    log(f"walk: mean local vx after warmup {out['mean_vx']:+.3f}, "
        f"mean |vy| {out['mean_abs_vy']:.3f}")
    log(f"walk: uprightness min {out['upright_min']:.3f} "
        f"(never flipped: {out['upright_min'] > 0})")
    log(f"walk: body height {out['height_min']:.3f} - "
        f"{out['height_max']:.3f} m")
    if not out["upright_min"] > WALK_LIMITS["upright"]:
        raise AssertionError(f"walk: uprightness {out['upright_min']:.3f}")
    if not out["forward_m"] > WALK_LIMITS["forward_m"]:
        raise AssertionError(f"walk: only {out['forward_m']:.3f} m forward")
    if not abs(out["sideways_m"]) < WALK_LIMITS["sideways_m"]:
        raise AssertionError(f"walk: {out['sideways_m']:.3f} m sideways")
    return out


def run_walk(device, n_steps, seed=0):
    """``closed_loop`` for ``n_steps`` on the card: the summary dict, and
    the carry and plant state it ended in."""
    from quadruped_gym_tpu_torch.runtime import mpc_runtime

    pm, plant, cfg, cost_fn, cmd, carry, phys = walk_setup(device, seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    carry, phys, (ctrls, sens, costs) = mpc_runtime.closed_loop(
        pm, cfg, cost_fn, carry, phys, cmd, n_steps, plant_model=plant)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if ctrls.shape != (n_steps, 12) or sens.shape != (n_steps, 33):
        raise AssertionError("walk: wrong trajectory shapes")
    out = walk_summary(pm, ctrls, sens, costs, n_steps, wall)
    return out, carry, phys


def phase_loop(rec):
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics import engine
    from quadruped_gym_tpu_torch.runtime import mpc_runtime

    dev = torch.device("cuda")
    iters = walk_config().mppi.iterations

    def counted(tag, steps):
        got = (cuda_engine.launch_counts[ROLLOUT],
               cuda_engine.launch_counts[SUBSTEP])
        if got != (steps * iters, 0):
            raise AssertionError(
                f"{tag}: {got[0]} fused and {got[1]} substep launches in "
                f"{steps} steps of {iters} iterations (want {steps * iters} "
                "and 0)")
        counts = rec.setdefault("launches", {})
        counts[ROLLOUT] = counts.get(ROLLOUT, 0) + got[0]
        return got[0]

    # 1. the walk
    cuda_engine.reset_launch_counts()
    walk, carry, phys = run_walk(dev, WALK_STEPS)
    n = counted("closed_loop", WALK_STEPS)
    walk["period_s"] = walk["wall_s"] / WALK_STEPS
    log(f"loop: closed_loop {WALK_STEPS} steps, {n} fused_rollout_cost "
        f"launches, 0 substep launches; {walk['period_s']:.4f} s per control "
        f"period (host clock, one synchronise at the end); card: "
        f"{rec['card']}")
    rec["walk"] = walk

    # 2. the delayed loop from the same start, oracle plant and lane plant
    rec["delayed"] = {}
    for plant_engine in ("aos", "lane"):
        pm, plant, cfg, cost_fn, cmd, carry0, phys0 = walk_setup(dev, seed=1)
        cuda_engine.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, end, (ctrls, sens, costs) = mpc_runtime.delayed_closed_loop(
            pm, cfg, cost_fn, carry0, phys0, cmd, DELAYED_STEPS,
            plant_model=plant, predictor="auto", plant_engine=plant_engine)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted(f"delayed_closed_loop plant_engine={plant_engine}",
                DELAYED_STEPS)
        if not bool((ctrls[0] == carry0.prev_ctrl).all()):
            raise AssertionError("delayed loop: step 0 did not apply the "
                                 "standing control")
        if not all(bool(torch.isfinite(x).all())
                   for x in (ctrls, sens, costs, end.qpos, end.qvel)):
            raise AssertionError("delayed loop: non-finite values")
        if not float(end.qpos[2]) > 0.03:
            raise AssertionError("delayed loop: the robot fell through")
        rec["delayed"][plant_engine] = {"period_s": wall / DELAYED_STEPS,
                                        "base_z": float(end.qpos[2])}
        log(f"loop: delayed_closed_loop {DELAYED_STEPS} steps, predictor "
            f"auto (lane), plant_engine {plant_engine}: step 0 applied the "
            f"standing control; {wall / DELAYED_STEPS:.4f} s per period "
            f"(predict + plan + plant; host clock); base z "
            f"{float(end.qpos[2]):.4f}; card: {rec['card']}")

    # 3. the period's parts, each followed by a synchronise, going on from
    # where the walk ended (not part of the counted run)
    pm, plant, cfg, cost_fn, cmd, _, _ = walk_setup(dev, seed=0)
    parts = {"plan_and_act": [], "oracle_control_step": [],
             "lane_control_step": []}
    lane_phys = phys
    for _ in range(SPLIT_PERIODS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl, carry, _ = mpc_runtime.plan_and_act(pm, cfg, cost_fn, carry,
                                                  phys, cmd)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        phys = engine.control_step(
            plant, phys, ctrl, cfg.plant_frame_skip,
            max_contacts=cfg.plant_max_contacts,
            solver_iterations=cfg.plant_solver_iterations)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lane_phys = mpc_runtime.lane_control_step(
            plant, lane_phys, ctrl, cfg.plant_frame_skip,
            solver_iterations=cfg.plant_solver_iterations,
            ls_iterations=2 * cfg.plant_solver_iterations)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts["plan_and_act"].append(t1 - t0)
        parts["oracle_control_step"].append(t2 - t1)
        parts["lane_control_step"].append(t3 - t2)
    split = {k: float(np.median(v[1:])) for k, v in parts.items()}
    fs = cfg.plant_frame_skip
    rec["loop_split"] = dict(
        split, each=parts,
        oracle_substep_ms=1e3 * split["oracle_control_step"] / fs,
        lane_substep_ms=1e3 * split["lane_control_step"] / fs)
    log(f"loop split (median of {SPLIT_PERIODS} periods after the first, "
        f"host clock, synchronised after each part): plan_and_act "
        f"{split['plan_and_act']:.4f} s; oracle control_step "
        f"{split['oracle_control_step']:.4f} s = "
        f"{rec['loop_split']['oracle_substep_ms']:.2f} ms per substep; "
        f"lane_control_step (the plant of plant_engine='lane') "
        f"{split['lane_control_step']:.4f} s = "
        f"{rec['loop_split']['lane_substep_ms']:.2f} ms per substep; "
        f"card: {rec['card']}")

    # 4. what the card did in one period's parts: one traced call of each,
    # its device time held against the untraced medians above
    dev_s, n_dev, _ = traced(lambda: engine.control_step(
        plant, phys, ctrl, fs, max_contacts=cfg.plant_max_contacts,
        solver_iterations=cfg.plant_solver_iterations))
    plan_dev_s, plan_n_dev, _ = traced(lambda: mpc_runtime.plan_and_act(
        pm, cfg, cost_fn, carry, phys, cmd))
    if n_dev == 0 or plan_n_dev == 0:
        raise AssertionError("loop: the profiler saw no device activity")
    rec["loop_trace"] = {
        "oracle_device_s": dev_s, "oracle_device_activities": n_dev,
        "oracle_activities_per_substep": n_dev / fs,
        "oracle_idle_share": 1.0 - dev_s / split["oracle_control_step"],
        "plan_device_s": plan_dev_s, "plan_device_activities": plan_n_dev,
        "plan_idle_share": 1.0 - plan_dev_s / split["plan_and_act"]}
    log(f"loop trace (torch.profiler, one call each; device time over the "
        f"untraced median above): oracle control_step ran {n_dev} kernels "
        f"and copies = {n_dev / fs:.0f} per substep, {1e3 * dev_s:.3f} ms "
        f"on the card = {1e6 * dev_s / n_dev:.2f} us each, the card idle "
        f"{100 * rec['loop_trace']['oracle_idle_share']:.1f} % of the "
        f"{split['oracle_control_step']:.4f} s; plan_and_act ran "
        f"{plan_n_dev}, {1e3 * plan_dev_s:.3f} ms on the card, idle "
        f"{100 * rec['loop_trace']['plan_idle_share']:.1f} % of the "
        f"{split['plan_and_act']:.4f} s; card: {rec['card']}")


def train_run(rec, out, argv, first, n_iter, steps):
    """``rl.train.main(argv)`` into ``out`` on the card, checked: every
    metric finite, the iterations numbered on from ``first``, the
    checkpoint's step and one CSV row per policy step so far, the
    parameters on the card. Returns (train_state, iterations)."""
    from quadruped_gym_tpu_torch.rl import train
    from quadruped_gym_tpu_torch.runtime import checkpoint
    from quadruped_gym_tpu_torch.utils.metrics import read_reward_csv

    ts, its = train.main(["--output", out] + argv)
    torch.cuda.synchronize()
    if [it.index for it in its] != list(range(first, first + n_iter)):
        raise AssertionError(f"train: iterations {[it.index for it in its]}")
    for it in its:
        for name, x in zip(it.metrics._fields, it.metrics):
            if not bool(torch.isfinite(x).all()):
                raise AssertionError(f"train iteration {it.index}: {name} "
                                     "is not finite")
    where = {p.device.type for p in ts.net.parameters()}
    if where != {"cuda"} or ts.obs.device.type != "cuda":
        raise AssertionError(f"train: parameters on {where}")
    _, step = checkpoint.read(os.path.join(out, "policy"))
    if step != first + n_iter or int(ts.update_idx) != first + n_iter:
        raise AssertionError(f"train: checkpoint step {step}, update_idx "
                             f"{int(ts.update_idx)} after iteration "
                             f"{first + n_iter - 1}")
    rows, _, comp, _ = read_reward_csv(os.path.join(out,
                                                    "rewards_continuous.csv"))
    if list(rows) != list(range((first + n_iter) * steps)) \
            or not np.isfinite(comp).all():
        raise AssertionError(f"train: {len(rows)} CSV rows after "
                             f"{first + n_iter} updates of {steps} steps")
    for it in its:
        log(f"train iteration {it.index} ({' '.join(argv)}): "
            f"{it.seconds:.3f} s an update (host clock, ends in the metrics' "
            f"read-back), mean step reward "
            f"{float(it.metrics.mean_reward.mean()):.4f}, approx_kl "
            f"{float(it.metrics.approx_kl[-1]):.5f}; card: {rec['card']}")
    log(f"train: checkpoint step {step}, {len(rows)} CSV rows, log_std max "
        f"{float(ts.net.log_std.detach().max()):.4f} after the call")
    return ts, its


def phase_train(rec):
    from quadruped_gym_tpu_torch import convert
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.rl import networks, ppo, train

    cfg = ppo.PPOConfig()  # the trainer's defaults
    env_cfg = train.make_env_config(train._parser().parse_args(TRAIN_ARGS))
    m = spec.get_mpc_plant_model()
    n_env, n_step, fs = cfg.num_envs, cfg.num_steps, env_cfg.frame_skip
    out = {"num_envs": n_env, "num_steps": n_step, "frame_skip": fs}
    rec["train"] = out

    def no_kernels(tag):
        got = (cuda_engine.launch_counts[ROLLOUT],
               cuda_engine.launch_counts[SUBSTEP])
        if got != (0, 0):
            raise AssertionError(f"{tag}: {got[0]} fused and {got[1]} "
                                 "substep launches (want none)")

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        # (a) two iterations at the defaults, then a resume with one more
        # and one of fine-tune
        run_dir = os.path.join(tmp, "run")
        cuda_engine.reset_launch_counts()
        ts, its = train_run(rec, run_dir, TRAIN_ARGS + ["--iterations", "2"],
                            0, 2, n_step)
        ts, its2 = train_run(rec, run_dir, TRAIN_ARGS + [
            "--iterations", "1", "--finetune-iterations", "1"], 2, 2, n_step)
        no_kernels("train")
        if not float(ts.net.log_std.detach().max()) <= -1.2:
            raise AssertionError("train: the fine-tune left log_std above "
                                 "-1.2")
        out["update_s"] = [it.seconds for it in its + its2]

        # one more update in its two parts, a synchronise after each
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        env_state, obs, traj = ppo._rollout(m, env_cfg, cfg, ts.net,
                                            ts.env_state, ts.obs,
                                            ts.generator)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ppo._optimize(cfg, ts.net, ts.opt, ts.generator, traj, obs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.update(rollout_s=t1 - t0, learn_s=t2 - t1)
        out["env_steps_per_s"] = n_env * n_step / (t2 - t0)
        out["substep_ms"] = 1e3 * out["rollout_s"] / (n_step * fs)
        log(f"train split (one update, host clock, a synchronise after "
            f"each part): rollout {out['rollout_s']:.3f} s = "
            f"{out['rollout_s'] / n_step:.4f} s an env step = "
            f"{out['substep_ms']:.2f} ms a substep ({n_env} envs, oracle "
            f"engine, mpc_plant, frame_skip {fs}); learning (GAE + "
            f"{cfg.epochs} x {cfg.num_minibatches} minibatches of "
            f"{cfg.batch_size // cfg.num_minibatches}) {out['learn_s']:.3f} "
            f"s; {out['env_steps_per_s']:.1f} env-steps/s; card: "
            f"{rec['card']}")

        # one traced update, its rollout cut to TRACE_ENV_STEPS env steps
        # (every env step launches the same kernels); the learning half
        # traced whole, on the rollout above
        cut = dataclasses.replace(cfg, num_steps=TRACE_ENV_STEPS)
        r_dev, r_n, _ = traced(lambda: ppo._rollout(
            m, env_cfg, cut, ts.net, env_state, obs, ts.generator))
        l_dev, l_n, _ = traced(lambda: ppo._optimize(
            cfg, ts.net, ts.opt, ts.generator, traj, obs))
        if r_n == 0 or l_n == 0:
            raise AssertionError("train: the profiler saw no device activity")
        step_s = out["rollout_s"] / n_step
        dev_step_s = r_dev / TRACE_ENV_STEPS
        out["trace"] = {
            "env_steps_traced": TRACE_ENV_STEPS,
            "rollout_device_s": r_dev, "rollout_activities": r_n,
            "activities_per_env_step": r_n / TRACE_ENV_STEPS,
            "rollout_idle_share": 1.0 - dev_step_s / step_s,
            "learn_device_s": l_dev, "learn_activities": l_n,
            "learn_idle_share": 1.0 - l_dev / out["learn_s"],
            "idle_share": 1.0 - (dev_step_s * n_step + l_dev) / (t2 - t0)}
        tr = out["trace"]
        log(f"train trace (torch.profiler; the rollout traced for "
            f"{TRACE_ENV_STEPS} env steps, the learning half whole; device "
            f"time over the untraced split above): an env step ran "
            f"{r_n / TRACE_ENV_STEPS:.0f} kernels and copies = "
            f"{r_n / (TRACE_ENV_STEPS * fs):.0f} a substep, "
            f"{1e3 * dev_step_s:.2f} ms on the card = {1e6 * r_dev / r_n:.2f} "
            f"us each, the card idle {100 * tr['rollout_idle_share']:.1f} % "
            f"of the rollout; the learning ran {l_n}, {1e3 * l_dev:.2f} ms on "
            f"the card, idle {100 * tr['learn_idle_share']:.1f} %; the update "
            f"idle {100 * tr['idle_share']:.1f} % ({n_step} env steps at the "
            f"traced rate); card: {rec['card']}")
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        no_kernels("train split and trace")

        # (b) the leg-engine env, cut in depth
        lane_dir = os.path.join(tmp, "lane")
        _, lane = train_run(rec, lane_dir, TRAIN_ARGS + [
            "--lane-physics", "--iterations", "1", "--num-steps",
            str(LANE_TRAIN_STEPS), "--timesteps-per-iteration",
            str(n_env * LANE_TRAIN_STEPS)], 0, 1, LANE_TRAIN_STEPS)
        no_kernels("train --lane-physics")
        out["lane_update_s"] = lane[0].seconds
        log(f"train --lane-physics (cut to {LANE_TRAIN_STEPS} env steps from "
            f"{n_step}: the eager leg engine takes seconds an env step at "
            f"{n_env} envs): {lane[0].seconds:.3f} s for the update = at most "
            f"{lane[0].seconds / LANE_TRAIN_STEPS:.3f} s an env step "
            f"(learning included); card: {rec['card']}")

    # (c) the committed policy on the run's observations: float32 on the
    # card against float64 on the CPU
    with np.load(os.path.join(POLICY, "state.npz")) as data:
        net32 = convert.policy_params(data, torch.float32, "cuda")
        net64 = convert.policy_params(data, torch.float64, "cpu")
    obs = ts.obs
    errs = {}
    with torch.no_grad():
        for name, fn in (("actor_mean", networks.actor_mean),
                         ("value", networks.value)):
            got = fn(net32, obs).double().cpu()
            want = fn(net64, obs.double().cpu())
            errs[name] = float((got - want).abs().max() / want.abs().max())
    out["policy_rel_err"] = errs
    log(f"train policy check: {POLICY_TOL:g} allowed; artifacts/walk_r5 "
        f"policy on {obs.shape[0]} observations of the run, float32 on the "
        f"card vs float64 on the CPU: max error over max |output| "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
        + f"; card: {rec['card']}")
    if not max(errs.values()) <= POLICY_TOL:
        raise AssertionError(f"train: the policy on the card is off by "
                             f"{max(errs.values()):.2e}")
    log(f"train: peak device memory {out['peak_mem_gb']:.2f} GB; 0 "
        f"fused_rollout_cost and 0 substep launches; card: {rec['card']}")


def episode_steps(max_time, h, frame_skip, dtype=np.float32):
    """Control steps of an episode that ends at ``time >= max_time`` on a
    clock summing ``h`` in ``dtype``: in float32 the sum of 300 steps of
    0.002 s is just under 0.6, so that episode takes one step more than
    in float64."""
    t, n, end = dtype(0), 0, dtype(max_time)
    while not t >= end:
        for _ in range(frame_skip):
            t = dtype(t + dtype(h))
        n += 1
    return n


def phase_eval(rec):
    """The trainer's per-iteration eval: the committed policy through
    ``eval_rollout`` on the card (float32, the gym env on ``full``), the
    cost of its control step, and ``rl.train.main`` at its defaults with
    the eval on. No kernel runs on this path (the gym env steps the oracle
    engine, as in the JAX package)."""
    from quadruped_gym_tpu_torch import convert
    from quadruped_gym_tpu_torch.envs import gym_env, rendering
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics import engine
    from quadruped_gym_tpu_torch.rl import evaluate, networks, train
    from quadruped_gym_tpu_torch.utils import plot

    found = {"gymnasium": gym_env.gym is not None,
             "cv2": rendering.HAVE_CV2,
             "matplotlib": plot.have_matplotlib()}
    out = {"found": found}
    rec["eval"] = out
    log("eval: optional packages found: "
        + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in found.items()))
    with np.load(os.path.join(POLICY, "state.npz")) as data:
        net = convert.policy_params(data, torch.float32, "cuda")

    cuda_engine.reset_launch_counts()
    # (a) the committed policy, one episode cut to EVAL_MAX_TIME
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    em = evaluate.eval_rollout(net, obs_window=10, max_time=EVAL_MAX_TIME,
                               frame_skip=10, deterministic=True, seed=0)
    wall = time.perf_counter() - t0
    env = gym_env.POWalkingQuadrupedEnv(obs_window=10, max_time=EVAL_EPISODE_S,
                                        frame_skip=10)
    step_dt = env.pm.timestep * env.frame_skip
    want_steps = episode_steps(EVAL_MAX_TIME, env.pm.timestep, env.frame_skip)
    em.pop("rewards")
    out["rollout"] = dict(em, wall_s=wall, step_s=wall / em["steps"])
    log(f"eval: walk_r5 through eval_rollout on the card (float32, "
        f"POWalkingQuadrupedEnv on full, obs window 10, frame_skip 10, "
        f"{env._cfg.max_contacts} contacts, Newton budget "
        f"{env.pm.solver_iterations}): {em['steps']} steps, return "
        f"{em['episode_return']:.3f}, survived {em['survived']}, tracking "
        f"error {em['mean_tracking_error']:.4f} m/s, uprightness "
        f"{em['mean_uprightness']:.4f}; {wall:.3f} s = "
        f"{out['rollout']['step_s']:.4f} s a control step (host clock, "
        f"actor and read-backs included); card: {rec['card']}")
    if not (em["steps"] == want_steps and em["survived"]
            and np.isfinite(em["episode_return"])
            and em["mean_uprightness"] > EVAL_LIMITS["upright"]
            and em["mean_tracking_error"] < EVAL_LIMITS["tracking"]):
        raise AssertionError(f"eval: the policy does not walk ({em}; want "
                             f"{want_steps} steps, {EVAL_LIMITS})")

    # (b) one control step: host clock, each step synchronised, then one
    # traced step (the kernels of its substeps, device time, idle share);
    # the robot lands first (the reset state hangs 10 cm up: ~7 control
    # steps of free fall, which run no contact solve)
    env.control_inputs.set_orientation(0.0)
    env.control_inputs.set_velocity_speed_alpha(0.2, 0.0)
    obs, _ = env.reset()
    times = []
    for _ in range(EVAL_WARM_STEPS + EVAL_TIMED_STEPS):
        with torch.no_grad():
            a = networks.actor_mean(net, torch.as_tensor(
                obs, dtype=torch.float32, device="cuda")).cpu().numpy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs, *_ = env.step(np.clip(a, -1.0, 1.0))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_s = float(np.median(times[EVAL_WARM_STEPS:]))
    fs = env.frame_skip
    # the trace takes one substep of the env's physics (a whole control
    # step, ~217k kernels, kept the profiler ~2 minutes); the task layer
    # around it launches a few hundred a control step
    ctrl = torch.as_tensor(np.clip(a, -1.0, 1.0), dtype=torch.float32,
                           device="cuda")[None]
    t0 = time.perf_counter()
    dev_s, n_dev, _ = traced(lambda: engine.control_step(
        env.pm, env._state, ctrl, 1, max_contacts=env._cfg.max_contacts,
        solver_iterations=env._cfg.solver_iterations))
    trace_s = time.perf_counter() - t0
    if n_dev == 0:
        raise AssertionError("eval: the profiler saw no device activity")
    sub_s = step_s / fs
    out["step"] = {"each_s": times, "step_s": step_s,
                   "substep_ms": 1e3 * sub_s, "substep_device_s": dev_s,
                   "substep_device_activities": n_dev,
                   "idle_share": 1.0 - dev_s / sub_s}
    log(f"eval step (env.step on full at batch 1, median of "
        f"{EVAL_TIMED_STEPS} after {EVAL_WARM_STEPS} landing steps, host "
        f"clock, synchronised): "
        f"{step_s:.4f} s a control step = {1e3 * sub_s:.2f} ms a substep; "
        f"one traced substep (torch.profiler): {n_dev} kernels and copies, "
        f"{1e3 * dev_s:.3f} ms on the card = {1e6 * dev_s / n_dev:.2f} us "
        f"each, the card idle {100 * out['step']['idle_share']:.1f} % of "
        f"the substep (the trace took {trace_s:.1f} s); card: "
        f"{rec['card']}")

    # (c) what the trainer's eval costs an iteration: its 20 s episode at
    # the walking rate of (b), and at the whole cut episode's of (a) (its
    # first steps fall freely and are cheap), an extrapolation, beside the
    # train phase's update
    n_episode = episode_steps(EVAL_EPISODE_S, env.pm.timestep, fs)
    episode_s = n_episode * step_s
    update_s = rec.get("train", {}).get("update_s")
    out["episode_extrapolated_s"] = episode_s
    out["episode_extrapolated_s_from_a"] = n_episode * out["rollout"]["step_s"]
    log(f"eval extrapolation (not measured): the trainer's eval episode of "
        f"{EVAL_EPISODE_S:g} s = {n_episode} control steps at {step_s:.4f} s "
        f"(b) = {episode_s:.1f} s an iteration ("
        f"{out['episode_extrapolated_s_from_a']:.1f} s at the "
        f"{out['rollout']['step_s']:.4f} s of (a)), against an update of "
        + (f"{float(np.median(update_s)):.3f} s (train phase, median)"
           if update_s else "(train phase not run)")
        + f"; card: {rec['card']}")

    # (d) rl.train.main at the default 2,048 envs with the eval on
    with tempfile.TemporaryDirectory() as tmp:
        run = os.path.join(tmp, "run")
        argv = ["--output", run] + EVAL_TRAIN_ARGS
        if not found["cv2"]:
            log("eval: no OpenCV on this host, so --no-eval-video (a video "
                "needs cv2, as in the JAX trainer)")
            argv.append("--no-eval-video")
        _, its = train.main(argv)
        with open(os.path.join(run, "logs", "eval_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        want = episode_steps(0.2, env.pm.timestep, env.frame_skip)
        if (len(rows) != 1 or set(rows[0]) != EVAL_KEYS
                or rows[0]["iteration"] != 0 or rows[0]["steps"] != want
                or not np.isfinite(rows[0]["episode_return"])):
            raise AssertionError(f"train eval: eval_metrics.jsonl holds "
                                 f"{rows}")
        made = {name: os.path.exists(os.path.join(run, *name.split("/")))
                for name in ("videos/run_0.mp4", "plots/reward_plot_0.png",
                             "plots/reward_components_0.html")}
        expect = {"videos/run_0.mp4": found["cv2"],
                  "plots/reward_plot_0.png": found["matplotlib"],
                  "plots/reward_components_0.html": True}
        if made != expect:
            raise AssertionError(f"train eval: files {made}, want {expect}")
        out["train"] = {"update_s": its[0].seconds,
                        "eval_s": its[0].eval_seconds, "row": rows[0]}
        log(f"eval: rl.train.main {' '.join(EVAL_TRAIN_ARGS)} (2,048 envs, "
            f"the eval on): update {its[0].seconds:.3f} s, eval episode "
            f"{its[0].eval_seconds:.3f} s for {rows[0]['steps']} steps "
            f"(video {'on' if found['cv2'] else 'off'}); "
            f"eval_metrics.jsonl {rows[0]}; files {made}; card: "
            f"{rec['card']}")

    got = (cuda_engine.launch_counts[ROLLOUT],
           cuda_engine.launch_counts[SUBSTEP])
    if got != (0, 0):
        raise AssertionError(f"eval: {got[0]} fused and {got[1]} substep "
                             "launches (want none)")
    log(f"eval: 0 fused_rollout_cost and 0 substep launches; card: "
        f"{rec['card']}")


def traced(fn):
    """(device seconds, device activities, ``fn()``) under
    ``torch.profiler``: the summed durations and the number of the kernels
    and copies the card ran for it. The profiler slows the host, so the
    wall time of a traced call is not used."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    on_card = [ev for ev in prof.events()
               if ev.device_type == DeviceType.CUDA]
    device_s = 1e-6 * sum(ev.time_range.elapsed_us() for ev in on_card)
    return device_s, len(on_card), out


def bound(m, it, lsi, S, H, fs=FRAME_SKIP):
    """(bound_ms, bound_by, ops per rollout step): the plain version's
    operations (``cuda_engine.count_ops``) over the FP32 peak vs the
    bytes in and out over the HBM rate."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    per_step = cuda_engine.rollout_flops(m, 1, fs, it, lsi)
    ops = per_step * H * S
    nbytes = 4 * (S * H * m.nu + S + m.nq + m.nv + m.na + m.nu + 5)
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", per_step)


def phase_time(rec, iters=5, plain_h=2, seed=7):
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state

    dev, dt = torch.device("cuda"), torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cmd, prev = command(dt, dev), prev_ctrl(dt, dev)
    rec["timing"] = {}
    for model in ("planning", "fast_plant"):
        m = getattr(spec, f"get_{model}_model")()
        it, lsi = BUDGET[model]
        state = make_state(m, dtype=dt, device=dev)

        def run(seqs, fn=cuda_engine.fused_rollout_cost):
            return fn(m, state, seqs, cmd, prev, FRAME_SKIP, it, lsi)

        all_seqs = [random_seqs(gen, S_MAIN, H_MAIN, dt, dev, 0.2)
                    for _ in range(iters + 1)]
        run(all_seqs[-1])  # warm-up
        torch.cuda.synchronize()
        host_s, dev_ms = [], []
        for seqs in all_seqs[:iters]:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            costs = run(seqs)
            e1.record()
            torch.cuda.synchronize()
            host_s.append(time.perf_counter() - t0)
            dev_ms.append(e0.elapsed_time(e1))
            if not bool(torch.isfinite(costs).all()):
                raise AssertionError(f"{model}: non-finite costs")
        rps = S_MAIN * iters / sum(host_s)
        # the plain version at a cut horizon, scaled to H=50
        short = all_seqs[0][:, :plain_h].contiguous()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        run(short, cuda_engine.fused_rollout_cost_reference)
        e1.record()
        torch.cuda.synchronize()
        plain_ms = e0.elapsed_time(e1) * H_MAIN / plain_h
        bound_ms, bound_by, per_step = bound(m, it, lsi, S_MAIN, H_MAIN)
        row = {"rollouts_per_s": rps, "solve_s": host_s,
               "ms": float(np.median(dev_ms)), "ms_each": dev_ms,
               "plain_ms": plain_ms, "plain_h": plain_h,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ops_per_rollout_step": per_step, "budget": [it, lsi]}
        rec["timing"][model] = row
        log(f"time {model} ({it}/{lsi}): {rps:.1f} rollouts/s "
            f"(S={S_MAIN}, H={H_MAIN}, frame_skip {FRAME_SKIP}, float32; "
            f"host clock, synchronised per solve); kernel "
            f"{row['ms']:.3f} ms median (CUDA events); plain version "
            f"{plain_ms:.1f} ms (H={plain_h} scaled x{H_MAIN // plain_h}); "
            f"bound {bound_ms:.3f} ms by {bound_by} "
            f"({per_step:.0f} ops per rollout step); card: {rec['card']}")
    phase_time_loop_shape(rec, gen, cmd, prev)
    phase_time_substep(rec)


def phase_time_loop_shape(rec, gen, cmd, prev, iters=5):
    """B1 at the closed loop's shape (the ``loop`` phase's planner: 1,024
    rollouts, H=20, budget 4/8, planning model), CUDA events per launch,
    against its bound."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine
    from quadruped_gym_tpu_torch.physics.engine import make_state

    dev, dt = torch.device("cuda"), torch.float32
    walk = walk_config().mppi
    S, H, fs = walk.num_samples, walk.rollout.horizon, walk.rollout.frame_skip
    it, lsi = walk.lane_newton_iterations, walk.lane_ls_iterations
    m = spec.get_planning_model()
    state = make_state(m, dtype=dt, device=dev)
    seqs = random_seqs(gen, S, H, dt, dev, 0.2)
    ms = event_ms(lambda: cuda_engine.fused_rollout_cost(
        m, state, seqs, cmd, prev, fs, it, lsi), iters)
    bound_ms, bound_by, per_step = bound(m, it, lsi, S, H, fs)
    row = {"S": S, "H": H, "budget": [it, lsi], "ms": float(np.median(ms)),
           "ms_each": ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "ops_per_rollout_step": per_step}
    row["share"] = bound_ms / row["ms"]
    rec["timing"]["loop_shape"] = row
    log(f"time B1 at the loop's shape: planning {it}/{lsi}, S={S}, H={H}, "
        f"frame_skip {fs}, float32: {row['ms']:.3f} ms median of {iters} "
        f"launches (CUDA events); bound {bound_ms:.4f} ms by {bound_by} "
        f"({per_step:.0f} ops per rollout step): {100 * row['share']:.2f} % "
        f"of it; card: {rec['card']}")


def event_ms(fn, iters):
    """Per-call CUDA-event times of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        out.append(e0.elapsed_time(e1))
    return out


def phase_time_substep(rec, iters=5, seed=8):
    """``control_step`` per launch at the widths of its two main paths,
    its plain version on the same inputs, and its bound."""
    from quadruped_gym_tpu_torch.models import spec
    from quadruped_gym_tpu_torch.ops import cuda_engine

    dev, dt = torch.device("cuda"), torch.float32
    rec["substep_timing"] = {}
    for label, model, B, fs in (("planning", "planning", S_MAIN, FRAME_SKIP),
                                ("fast_plant", "fast_plant", S_MAIN,
                                 FRAME_SKIP),
                                ("env", "fast_plant", N_ENVS,
                                 ENV_FRAME_SKIP)):
        m = getattr(spec, f"get_{model}_model")()
        it, lsi = BUDGET[model]
        ls, ctrl = lane_inputs(m, "grounded", B, np.random.default_rng(seed),
                               dt, dev)
        ms = event_ms(lambda: cuda_engine.control_step(m, ls, ctrl, fs, it,
                                                       lsi), iters)
        plain = event_ms(lambda: cuda_engine.control_step_reference(
            m, ls, ctrl, fs, it, lsi), 1)
        ops = cuda_engine.substep_flops(m, fs, it, lsi)
        geo = cuda_engine.launch_geometry(cuda_engine.model_slots(m), dt, B)
        nbytes = 4 * B * (2 * (m.nq + m.nv + m.na) + m.nu + m.nsensordata)
        t_ops, t_bytes = B * ops / PEAK_FP32, nbytes / PEAK_BYTES
        row = {"B": B, "frame_skip": fs, "budget": [it, lsi],
               "ms": float(np.median(ms)), "ms_each": ms,
               "plain_ms": plain[0], "ops_per_lane": ops, "bytes": nbytes,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "blocks": geo.grid, "threads": geo.threads}
        rec["substep_timing"][label] = row
        log(f"time substep {label}: {model} {it}/{lsi}, B={B}, frame_skip "
            f"{fs}, float32: control_step {row['ms']:.3f} ms median of "
            f"{iters} (CUDA events); plain version {plain[0]:.1f} ms; bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} ({ops:.0f} ops "
            f"and {nbytes // B} bytes per lane); {row['blocks']} blocks of "
            f"{geo.threads} threads on 132 SMs; card: {rec['card']}")
    for label in ("planning", "fast_plant"):
        fused = rec["timing"][label]["ms"] / H_MAIN
        per_launch = rec["substep_timing"][label]["ms"]
        log(f"time fused vs per-control-step, {label}: one control step of "
            f"{S_MAIN} rollouts takes {fused:.3f} ms inside the fused "
            f"kernel and {per_launch:.3f} ms as one substep-kernel launch; "
            f"card: {rec['card']}")
    k = rec["substep_timing"]["planning"]["ms"] * H_MAIN / 1e3
    if "custom_plan_s" in rec:
        solve = float(np.median(rec["custom_plan_s"][1:]))
        log(f"time custom-cost MPPI solve: {solve:.4f} s median of periods "
            f"1.. ({S_MAIN / solve:.1f} rollouts/s; S={S_MAIN}, H={H_MAIN}); "
            f"{H_MAIN} substep launches take {k:.4f} s of it "
            f"({100 * k / solve:.1f} %); CEM solve {rec['cem_solve_s']:.4f} s"
            f" for 3 iterations; card: {rec['card']}")
        rec["custom_solve_s"] = solve
        rec["custom_rollouts_per_s"] = S_MAIN / solve
    if "env_steps_per_s" in rec:
        e = rec["substep_timing"]["env"]["ms"]
        log(f"time env: {rec['env_steps_per_s']:.1f} env-steps/s at "
            f"{N_ENVS} envs ({rec['env_step_ms']:.3f} ms per step, of which "
            f"the kernel {e:.3f} ms, {100 * e / rec['env_step_ms']:.1f} %); "
            f"card: {rec['card']}")


def kernels_line(rec) -> dict:
    t = rec.get("timing", {}).get("planning", {})
    u = rec.get("substep_timing", {}).get("planning", {})
    launches = rec.get("launches", {})
    csrc = "quadruped_gym_tpu_torch/ops/csrc/"

    def row(name, source, replaces, err, times):
        return {"name": name, "route": "cuda", "source": csrc + source,
                "replaces": replaces, "launches": launches.get(name),
                "max_abs_err": rec.get(err), "ms": times.get("ms"),
                "plain_ms": times.get("plain_ms"),
                "bound_ms": times.get("bound_ms"),
                "bound_by": times.get("bound_by"), "library_ms": None}

    return {"kernels": [
        row(ROLLOUT, "rollout_kernel.cu",
            "quadruped_gym_tpu/ops/pallas_engine.py:249",
            "max_abs_err_main_shape", t),
        row(SUBSTEP, "substep_kernel.cu",
            "quadruped_gym_tpu/ops/pallas_engine.py:86",
            "substep_max_abs_err_main_shape", u),
    ]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {','.join(PHASES)}")
    ap.add_argument("--json-out", default=None,
                    help="also write every number to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {}
    phase_device(rec)
    for name in PHASES[1:]:
        if name in phases:
            t0 = time.perf_counter()
            globals()[f"phase_{name}"](rec)
            log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rec, f, indent=1)
    log(f"card: {rec['card']}")
    log(json.dumps(kernels_line(rec)))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
