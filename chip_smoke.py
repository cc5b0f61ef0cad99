#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases build,check  # build + kernel checks only

Phases, each of which raises on failure (nothing is caught):

1. device: the card's name and power limit (nvidia-smi).
2. build: every CUDA kernel from ``quadruped_gym_tpu_torch/ops/csrc``,
   all nvcc processes at once; build seconds and ptxas registers/spills.
3. check: each kernel against its plain PyTorch version on the card, on
   the same inputs, at the tolerances stated below.
4. main: the port's main path at full bench width: ``init_carry`` and 5
   receding-horizon periods of MPPI ``plan_and_act`` (65,536 rollouts,
   H=50, frame_skip 5, fused kernel, Newton/line-search 2/4, float32) on
   the planning model, each followed by ``lane_control_step``; then one
   fused solve on the fast-plant model at 4/8. The launch counters are set
   to 0 just before and read just after.
5. time: fused rollouts/s at S=65,536, H=50, float32 (synchronised per
   solve, 5 solves after a warm-up), the plain version's time, and the
   kernel's bound.

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

PHASES = ("device", "build", "check", "main", "time")
S_MAIN = 65536
H_MAIN = 50
FRAME_SKIP = 5
BUDGET = {"planning": (2, 4), "fast_plant": (4, 8)}
# published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores in FLOP/s (an FMA counts two, as cuda_engine.count_ops counts it),
# HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
F64_TOL = 1e-8
# float32: ~6e-8 rounding per operation, amplified through the Newton
# contact solve over 5 substeps; a wrong kernel misses by far more
F32_TOL = 1e-4


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
    from quadruped_gym_tpu_torch.ops import _build, cuda_engine

    t0 = time.perf_counter()
    _build.build_all((cuda_engine.KERNEL_SOURCE,), ("float32", "float64"))
    rec["build_s"] = time.perf_counter() - t0
    log(f"build: {rec['build_s']:.1f} s for float32 + float64 "
        f"({cuda_engine.KERNEL_SOURCE}, nvcc in parallel)")
    for dtype in ("float32", "float64"):
        report = _build.ptxas_report(cuda_engine.KERNEL_SOURCE, dtype)
        rec[f"ptxas_{dtype}"] = report
        log(f"ptxas {dtype}:\n{report}")


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


def phase_main(rec, periods=5):
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
    planning_launches = cuda_engine.launch_counts["fused_rollout_cost"]
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
    fast_launches = cuda_engine.launch_counts["fused_rollout_cost"]
    if fast_launches != 1:
        raise AssertionError(f"fast-plant solve launched the kernel "
                             f"{fast_launches} times")
    if not (bool(torch.isfinite(info["best_cost"]))
            and bool(torch.isfinite(fcarry.mean).all())):
        raise AssertionError("fast-plant solve: non-finite cost or plan")
    log(f"main fast_plant solve: best_cost {float(info['best_cost']):.4f}")
    rec["launches"] = planning_launches + fast_launches
    log(f"main: fused_rollout_cost launches {planning_launches} "
        f"(planning, {periods} periods) + {fast_launches} (fast plant); "
        f"{rec['main_s']:.2f} s for the planning periods "
        f"({sum(plan_s):.2f} s in plan_and_act, {sum(step_s):.2f} s in "
        f"lane_control_step)")


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


def kernels_line(rec) -> dict:
    t = rec.get("timing", {}).get("planning", {})
    return {"kernels": [{
        "name": "fused_rollout_cost",
        "route": "cuda",
        "source": "quadruped_gym_tpu_torch/ops/csrc/rollout_kernel.cu",
        "replaces": "quadruped_gym_tpu/ops/pallas_engine.py:249",
        "launches": rec.get("launches"),
        "max_abs_err": rec.get("max_abs_err_main_shape"),
        "ms": t.get("ms"),
        "plain_ms": t.get("plain_ms"),
        "bound_ms": t.get("bound_ms"),
        "bound_by": t.get("bound_by"),
        "library_ms": None,
    }]}


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
