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
   must refuse (too much shared memory) has to raise.
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
7. time: fused rollouts/s at S=65,536, H=50, float32 (synchronised per
   solve, 5 solves after a warm-up); the substep kernel's ``control_step``
   per launch at B=65,536 and B=2,048; each kernel's plain version and
   bound; the custom-cost solve and the env's steps/s as phases 5 and 6
   measured them.

Phases 4, 5 and 6 each set the launch counters to 0 just before driving
their path and read them just after.

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. With no CUDA device, or with any
failure, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

PHASES = ("device", "build", "check", "main", "plan", "env", "time")
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
    rec["max_abs_err_main_shape"] = max(
        check_case(rec, "f32 planning grounded (main-path width)",
                   "planning", "grounded", S_MAIN, 1, FRAME_SKIP,
                   BUDGET["planning"], f32, F32_TOL, seed=5),
        check_case(rec, "f32 fast_plant grounded (main-path width)",
                   "fast_plant", "grounded", S_MAIN, 1, FRAME_SKIP,
                   BUDGET["fast_plant"], f32, F32_TOL, seed=6),
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
    rec.setdefault("launches", {})[ROLLOUT] = planning_launches + fast_launches
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
    env = VectorWalkingEnv(m, cfg, N_ENVS, seed=4)
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


def bound(m, it, lsi, S, H):
    """(bound_ms, bound_by, ops per rollout step): the plain version's
    operations (``cuda_engine.count_ops``) over the FP32 peak vs the
    bytes in and out over the HBM rate."""
    from quadruped_gym_tpu_torch.ops import cuda_engine

    per_step = cuda_engine.rollout_flops(m, 1, FRAME_SKIP, it, lsi)
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
    phase_time_substep(rec)


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
