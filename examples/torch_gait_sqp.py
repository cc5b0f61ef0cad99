"""Gradient-based gait optimization (SQP or iLQR) with the PyTorch port.

Counterpart of ``examples/gait_sqp.py`` for ``quadruped_gym_tpu_torch``,
on the card unless ``--cpu`` is given. BASELINE config 4 ("iLQR/SQP
contact-implicit gait optimization") at its named scale: H=50 control
steps, float32, full contact dynamics.

What it does:
  1. settles the robot to stance (400 physics steps under the hold ctrl,
     at the model's Newton budget; once per process, like the cost of
     holding that stance over the horizon);
  2. solves an H-step trajectory optimization for a forward velocity
     command from a trot-phased sine warm start (or the standing hold, or
     a few MPPI refinements of the sine);
  3. re-rolls the optimized control sequence through the dynamics and
     reports walking-quality metrics (forward progress, speed tracking,
     uprightness), the per-iteration cost curve and the solve time
     (``--split``: each part of an iteration, a synchronise after each).

Run:  python examples/torch_gait_sqp.py --solver sqp --horizon 50
      python examples/torch_gait_sqp.py --solver sqp --linearize fd --tune-eps
      python examples/torch_gait_sqp.py --solver ilqr
Writes artifacts/torch_gait_<solver>_report.json (or ``--out``).
``--shard`` cuts SQP's condensation over the ranks of a ``horizon`` mesh
(every rank of a running ``torch.distributed`` group, else this process
alone).
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quadruped_gym_tpu_torch._device import resolve_device  # noqa: E402
from quadruped_gym_tpu_torch import parallel  # noqa: E402
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.parallel.mesh import group_scope  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine  # noqa: E402
from quadruped_gym_tpu_torch.solvers import (ilqr, mppi, rollout,  # noqa: E402
                                             sqp)
from quadruped_gym_tpu_torch.tasks import commands, rewards  # noqa: E402

HOLD = np.array([0.0, 0.0, -0.5] * 4)
SETTLE_STEPS = 400


def sine_warm_start(horizon, ctrl_dt, dtype, device,
                    freq_hz=2.5, hip_amp=0.2, knee_amp=0.15):
    """Trot-phased sinusoidal leg pattern around the standing hold.

    Gradient gait optimization from the exact standing fixed point stalls:
    rest is a symmetric stationary point, so the first step has nothing to
    break symmetry with. A small diagonal-pair (trot) oscillation puts the
    incumbent on the basin's slope; the solver then shapes it."""
    t = np.arange(horizon) * ctrl_dt
    w = 2.0 * np.pi * freq_hz
    us = np.tile(HOLD, (horizon, 1))
    phase = [0.0, np.pi, 0.0, np.pi]  # diagonal pairs in phase
    for leg in range(4):
        us[:, 3 * leg + 0] += hip_amp * np.sin(w * t + phase[leg])
        us[:, 3 * leg + 1] += knee_amp * np.sin(w * t + phase[leg]
                                                + 0.5 * np.pi)
    return torch.as_tensor(np.clip(us, -1.0, 1.0), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def settle_state(dtype, device, steps=SETTLE_STEPS):
    """The fast plant settled to stance: ``steps`` physics steps under the
    hold control at the model's Newton budget. Deterministic, so it is
    made once per process and shared by every run in it."""
    m = spec.get_fast_plant_model()
    hold = torch.as_tensor(HOLD, dtype=dtype, device=device)
    st = engine.make_state(m, dtype, device)
    for _ in range(steps):
        st = engine.step(m, st, hold)
    return st


@functools.lru_cache(maxsize=None)
def hold_cost(dtype, device, settle_steps, horizon, frame_skip, speed,
              smooth_eps):
    """The cost of holding the settled stance for H steps: the do-nothing
    policy a gait must beat (once per process and settings)."""
    m = spec.get_fast_plant_model()
    rcfg, cost_fn, cmd, prev = problem(m, dtype, device, horizon, frame_skip,
                                       speed, smooth_eps)
    return float(rollout.rollout_cost(
        m, rcfg, cost_fn, settle_state(dtype, device, settle_steps),
        prev.repeat(horizon, 1), cmd, prev))


def problem(m, dtype, device, horizon, frame_skip, speed, smooth_eps):
    """(rollout config, cost, command, hold control) of the gait problem:
    12 contacts, 4 Newton passes, the smoothed walking cost, a forward
    command."""
    rcfg = rollout.RolloutConfig(horizon=horizon, frame_skip=frame_skip,
                                 max_contacts=12, solver_iterations=4)
    cost_fn = rollout.make_cost_fn(m, vel_smooth_eps=smooth_eps)
    cmd = commands.make(torch.tensor([speed, 0.0], dtype=dtype, device=device),
                        torch.tensor(0.0, dtype=dtype, device=device))
    return rcfg, cost_fn, cmd, torch.as_tensor(HOLD, dtype=dtype,
                                               device=device)


def trajectory_metrics(m, rcfg, state0, us, sl):
    """Re-rollout the optimized controls; walking-quality numbers."""
    st, sens = state0, []
    for u in us:
        st = engine.control_step(m, st, u, rcfg.frame_skip,
                                 max_contacts=rcfg.max_contacts,
                                 solver_iterations=rcfg.solver_iterations)
        sens.append(st.sensordata)
    sens = torch.stack(sens)
    pos = sens[:, sl.pos: sl.pos + 3]
    return {
        "forward_displacement_m": float(pos[-1, 0] - pos[0, 0]),
        "mean_local_vx": float(sens[:, sl.vel].mean()),
        "final_height": float(pos[-1, 2]),
        "min_uprightness": float(sens[:, sl.zaxis + 2].min()),
    }


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--solver", choices=("sqp", "ilqr"), default="sqp")
    p.add_argument("--horizon", type=int, default=50)
    p.add_argument("--frame-skip", type=int, default=5)
    p.add_argument("--iterations", type=int, default=10)
    p.add_argument("--linearize", choices=("ad", "fd"), default="ad",
                   help="'ad' (default): forward-mode AD through the "
                        "contact Newton, exact branch tangents; 'fd': "
                        "central differences, which straddle "
                        "contact-branch discontinuities")
    p.add_argument("--fd-eps", type=float, default=None,
                   help="FD epsilon (default: tuned per dtype)")
    p.add_argument("--speed", type=float, default=0.2)
    p.add_argument("--tune-eps", action="store_true",
                   help="sweep the FD epsilon (with --linearize fd)")
    p.add_argument("--init", choices=("sine", "hold", "mppi"), default="sine",
                   help="initial guess: trot-phased sine (default), the "
                        "standing hold (stalls: rest is a symmetric "
                        "stationary point of the smoothed cost), or 'mppi': "
                        "a few sampling-MPC refinements of the sine seed")
    p.add_argument("--settle-steps", type=int, default=SETTLE_STEPS,
                   help="physics steps of the settle to stance")
    p.add_argument("--mppi-samples", type=int, default=64)
    p.add_argument("--mppi-iters", type=int, default=4)
    p.add_argument("--init-freq", type=float, default=2.5,
                   help="warm-start trot frequency (Hz)")
    p.add_argument("--init-hip-amp", type=float, default=0.2)
    p.add_argument("--init-knee-amp", type=float, default=0.15)
    p.add_argument("--smooth-eps", type=float, default=0.02,
                   help="velocity-norm smoothing of the progress terms "
                        "(m/s); 0 = the exact task cost, whose gradient "
                        "at rest is degenerate")
    p.add_argument("--shard", action="store_true",
                   help="cut SQP's condensation over the ranks of a "
                        "'horizon' mesh")
    p.add_argument("--split", action="store_true",
                   help="time each part of an iteration, a synchronise "
                        "after each")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--f64", action="store_true", help="run in float64")
    p.add_argument("--out", default=None)
    return p


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    with group_scope():
        return _run(args, device)


def _run(args, device):
    dtype = torch.float64 if args.f64 else torch.float32
    print(f"device: {device}, dtype: {str(dtype).removeprefix('torch.')}",
          flush=True)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # the plant-fidelity model: feet, shins and ankle servos with
    # support-decimated hulls
    m = spec.get_fast_plant_model()
    sl = rewards.SensorSlices.from_model(m)
    settings = (args.horizon, args.frame_skip, args.speed, args.smooth_eps)
    rcfg, cost_fn, cmd, prev = problem(m, dtype, device, *settings)
    if args.init in ("sine", "mppi"):
        us0 = sine_warm_start(
            args.horizon, args.frame_skip * float(m.timestep), dtype, device,
            freq_hz=args.init_freq, hip_amp=args.init_hip_amp,
            knee_amp=args.init_knee_amp,
        )
    else:
        us0 = prev.repeat(args.horizon, 1)

    t0 = time.perf_counter()
    state0 = settle_state(dtype, device, args.settle_steps)
    sync()
    print(f"settled stance: z={float(state0.qpos[2]):.4f} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    mppi_seed_cost = None
    if args.init == "mppi":
        # hybrid warm start: sampling explores, gradients converge
        mcfg = mppi.MPPIConfig(
            num_samples=args.mppi_samples, sigma=0.15, temperature=1.0,
            iterations=args.mppi_iters, rollout=rcfg,
        )
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        t0 = time.perf_counter()
        res = mppi.plan(m, mcfg, cost_fn, state0, us0, cmd, prev, gen)
        us0 = torch.clamp(res.mean, -1.0, 1.0)
        mppi_seed_cost = float(res.best_cost)
        print(f"mppi warm start ({args.mppi_samples}x{args.mppi_iters}): "
              f"best cost {mppi_seed_cost:.1f} in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)

    mesh = None
    if args.shard:
        mesh = parallel.make_mesh(("horizon",), device=device)
        print(f"condensation sharded over {mesh.size()} rank(s)", flush=True)

    def solve(eps, on_part):
        if args.solver == "sqp":
            cfg = sqp.SQPConfig(iterations=args.iterations, rollout=rcfg,
                                linearize=args.linearize, fd_eps=eps)
            return sqp.solve(m, cfg, cost_fn, state0, us0, cmd, prev,
                             mesh=mesh, on_part=on_part)
        cfg = ilqr.ILQRConfig(iterations=args.iterations, rollout=rcfg,
                              linearize=args.linearize, fd_eps=eps)
        return ilqr.solve(m, cfg, cost_fn, state0, us0, cmd, prev,
                          on_part=on_part)

    # f32 central differences round at ~1e-7 * state scale, so eps ~ 3e-4
    # balances rounding against truncation; f64 keeps 1e-5
    default_eps = 1e-5 if dtype == torch.float64 else 3e-4
    eps_list = (
        [1e-4, 3e-4, 1e-3, 3e-3] if (args.tune_eps and args.linearize == "fd")
        else [args.fd_eps or default_eps]
    )

    hold = hold_cost(dtype, device, args.settle_steps, *settings)
    print(f"standing-hold trajectory cost: {hold:.1f}", flush=True)

    lo = torch.as_tensor(m.actuator_ctrlrange[:, 0], dtype=dtype,
                         device=device)
    hi = torch.as_tensor(m.actuator_ctrlrange[:, 1], dtype=dtype,
                         device=device)
    report = {
        "solver": args.solver,
        "horizon": args.horizon,
        "frame_skip": args.frame_skip,
        "dtype": str(dtype).removeprefix("torch."),
        "iterations": args.iterations,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "linearize": args.linearize,
        "command_speed": args.speed,
        "init": args.init,
        "mppi_seed_cost": mppi_seed_cost,
        "vel_smooth_eps": args.smooth_eps,
        "standing_hold_cost": hold,
        "condensation_ranks": None if mesh is None else mesh.size(),
        "runs": [],
    }
    for eps in eps_list:
        parts = collections.defaultdict(float)
        clock = [0.0]

        def on_part(name):
            sync()
            now = time.perf_counter()
            parts[name] += now - clock[0]
            clock[0] = now

        sync()
        t0 = clock[0] = time.perf_counter()
        res = solve(eps, on_part if args.split else None)
        sync()
        dt = time.perf_counter() - t0
        metrics = trajectory_metrics(m, rcfg, state0, res.ctrl_seq, sl)
        u = res.ctrl_seq
        run = {
            "fd_eps": eps,
            "initial_cost": float(res.initial_cost),
            "final_cost": float(res.cost),
            "cost_history": [float(c) for c in res.cost_history],
            "solve_time_s": dt,
            "per_iteration_s": dt / max(args.iterations, 1),
            "ctrl_within_range": bool(((u >= lo) & (u <= hi)).all()),
            **metrics,
        }
        if args.split:
            run["rollout_s"] = parts.pop("rollout")
            run["split_s_per_iteration"] = {
                k: v / max(args.iterations, 1) for k, v in parts.items()}
        report["runs"].append(run)
        print(
            f"eps={eps:.0e}: cost {run['initial_cost']:.1f} -> "
            f"{run['final_cost']:.1f} in {dt:.2f}s "
            f"({run['per_iteration_s'] * 1e3:.0f} ms/iter); "
            f"fwd {run['forward_displacement_m'] * 100:.1f} cm, "
            f"mean vx {run['mean_local_vx']:.3f} m/s, "
            f"upright>={run['min_uprightness']:.2f}", flush=True)

    out = args.out or os.path.join(
        _REPO, "artifacts", f"torch_gait_{args.solver}_report.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}", flush=True)
    return report


if __name__ == "__main__":
    main()
