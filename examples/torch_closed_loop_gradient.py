"""Closed-loop receding-horizon GRADIENT MPC walk (SQP or iLQR) with the
PyTorch port.

Counterpart of ``examples/closed_loop_gradient.py`` for
``quadruped_gym_tpu_torch``, on the card unless ``--cpu`` is given: every
control period the shifted incumbent plan warm-starts a 1-iteration
condensed-QP SQP (or 2-iteration iLQR) solve from the CURRENT plant state,
and the first control is applied (``runtime.mpc_runtime.closed_loop``).

Writes ``artifacts/torch_closed_loop_<solver>.json`` (or ``--out``).

Run:  python examples/torch_closed_loop_gradient.py [--solver sqp|ilqr]
          [--steps 100] [--speed 0.15] [--horizon 20]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import torch  # noqa: E402

from quadruped_gym_tpu_torch._device import resolve_device  # noqa: E402
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine  # noqa: E402
from quadruped_gym_tpu_torch.runtime import mpc_runtime  # noqa: E402
from quadruped_gym_tpu_torch.solvers import ilqr, rollout, sqp  # noqa: E402
from quadruped_gym_tpu_torch.tasks import commands  # noqa: E402
from quadruped_gym_tpu_torch.tasks.rewards import SensorSlices  # noqa: E402


def _parser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--solver", choices=("sqp", "ilqr"), default="sqp")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--speed", type=float, default=0.15)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--linearize", choices=("ad", "fd"), default="ad",
                   help="dynamics linearization: forward-mode AD (default) "
                        "or central differences at --fd-eps")
    p.add_argument("--fd-eps", type=float, default=3e-4)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--out", default=None)
    return p


def setup(args, device):
    """(planning model, MPCConfig, cost_fn, cmd, start state, carry) of
    the walk, float32 on ``device``."""
    pm = spec.get_planning_model()
    rcfg = rollout.RolloutConfig(
        horizon=args.horizon, frame_skip=5, max_contacts=8,
        solver_iterations=4,
    )
    cfg = mpc_runtime.MPCConfig(
        solver=args.solver,
        sqp=sqp.SQPConfig(
            iterations=1, qp_iterations=15, rollout=rcfg,
            alphas=(1.0, 0.3, 0.1),
            linearize=args.linearize, fd_eps=args.fd_eps,
        ),
        ilqr=ilqr.ILQRConfig(
            iterations=2, rollout=rcfg, alphas=(1.0, 0.3, 0.1, 0.0),
            linearize=args.linearize, fd_eps=args.fd_eps,
        ),
        plant_frame_skip=5, plant_max_contacts=12,
        plant_solver_iterations=4,
    )
    # smoothed progress terms: the gradient solvers' quadratization is
    # blind at stance under the exact cost
    cost_fn = rollout.make_cost_fn(pm, vel_smooth_eps=0.02)
    cmd = commands.make(torch.tensor([args.speed, 0.0], device=device),
                        torch.tensor(0.0, device=device))
    phys = engine.make_state(pm, device=device)
    carry = mpc_runtime.init_carry(pm, cfg, horizon=args.horizon, seed=0,
                                   device=device)
    return pm, cfg, cost_fn, cmd, phys, carry


def main(argv=None):
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    pm, cfg, cost_fn, cmd, phys, carry = setup(args, device)

    sim_s = args.steps * cfg.plant_frame_skip * float(pm.timestep)
    print(f"walking {args.steps} control steps ({sim_s:.1f} s sim), "
          f"receding-horizon {args.solver} on {device}...", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    carry, phys, (ctrls, sens, costs) = mpc_runtime.closed_loop(
        pm, cfg, cost_fn, carry, phys, cmd, args.steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    print(f"done in {wall:.1f} s wall", flush=True)

    ctrl_hz = 1.0 / (cfg.plant_frame_skip * float(pm.timestep))
    sl = SensorSlices.from_model(pm)
    pos = sens[:, sl.pos: sl.pos + 3].cpu()
    vel = sens[:, sl.vel: sl.vel + 2].cpu()
    z = sens[:, sl.zaxis + 2].cpu()
    warm = args.steps // 4
    iters = getattr(cfg, args.solver).iterations
    report = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "solver": args.solver,
        "mode": "closed-loop receding horizon "
                f"({iters} solve iteration(s) per {ctrl_hz:.0f} Hz period,"
                " warm-started)",
        "control_rate_hz": ctrl_hz,
        "linearize": args.linearize,
        "fd_eps": args.fd_eps if args.linearize == "fd" else None,
        "command_mps": args.speed,
        "horizon": args.horizon,
        "control_steps": args.steps,
        "sim_seconds": sim_s,
        "traveled_xy_m": [float(pos[-1][0]), float(pos[-1][1])],
        "mean_vx_after_warmup": float(vel[warm:, 0].mean()),
        "mean_abs_vy": float(vel[warm:, 1].abs().mean()),
        "uprightness_min": float(z.min()),
        "never_flipped": bool(z.min() > 0),
        "body_height_range_m": [float(pos[:, 2].min()),
                                float(pos[:, 2].max())],
        "final_best_cost": float(costs[-1]),
        "all_finite": bool(torch.isfinite(ctrls).all()
                           and torch.isfinite(sens).all()
                           and torch.isfinite(costs).all()),
        "wall_s": wall,
        "period_s": wall / max(args.steps, 1),
    }
    out = args.out or os.path.join(
        _REPO, "artifacts", f"torch_closed_loop_{args.solver}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    print(f"wrote {out}", flush=True)
    return report


if __name__ == "__main__":
    main()
