"""Closed-loop quality frontier of the fast-plant fused planner's contact
budget, with the PyTorch port.

Counterpart of ``scripts/full_plant_budget_study.py`` for
``quadruped_gym_tpu_torch``, on the card unless ``--cpu`` is given. The
fast plant (feet, shins and ankle servos with decimated hulls) is planned
through the fused rollout kernel (B1) at its conservative Newton/
line-search budget of 4/8; the planning model runs 2/4. This script asks
whether the fast plant tracks a walk as well at 2/4: it runs the same
closed-loop velocity-tracking walk (MPPI, 1,024 samples, sigma 0.25,
temperature 0.5, 2 iterations, H=20, frame_skip 5, float32) at each
candidate budget and hull decimation, against the richer oracle plant
(``mpc_plant``: the lower-leg collision set with full hulls, 12
contacts, 4 Newton passes), planner/plant mismatch included:

    4/8 with n_secondary 64 (the shipping configuration)
    2/4 with n_secondary 64 (the planning model's budget)
    2/4 with n_secondary 32 (and harder shin/servo decimation)

A candidate is equivalent if its mean velocity error is within 0.01 m/s
of the 4/8 case's and no case flipped (``budget_verdict``). Every case
starts from the same carry seed.

Writes ``artifacts/torch_full_plant_budget_study.json`` (or ``--out``);
the JAX script's ``artifacts/full_plant_budget_study.json`` is never
touched.

Run:  python scripts/torch_full_plant_budget_study.py [--steps 200] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quadruped_gym_tpu_torch._device import (  # noqa: E402
    card_line, resolve_device)
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine  # noqa: E402
from quadruped_gym_tpu_torch.runtime import mpc_runtime  # noqa: E402
from quadruped_gym_tpu_torch.solvers import mppi, rollout  # noqa: E402
from quadruped_gym_tpu_torch.tasks import commands  # noqa: E402
from quadruped_gym_tpu_torch.tasks.rewards import SensorSlices  # noqa: E402

DTYPE = torch.float32
CASES = (
    (4, 8, 64),  # the shipping conservative configuration
    (2, 4, 64),  # candidate: the planning model's budget on the fast plant
    (2, 4, 32),  # candidate: + harder secondary-hull decimation
)
TOLERANCE_MPS = 0.01


def mpc_config(newton, ls, samples=1024, horizon=20):
    """The walk's planner at a Newton/line-search budget, and its plant."""
    return mpc_runtime.MPCConfig(
        solver="mppi",
        mppi=mppi.MPPIConfig(
            num_samples=samples, sigma=0.25, temperature=0.5, iterations=2,
            lane=True, lane_engine_impl="fused",
            lane_newton_iterations=newton, lane_ls_iterations=ls,
            rollout=rollout.RolloutConfig(horizon=horizon, frame_skip=5),
        ),
        plant_frame_skip=5, plant_max_contacts=12,
        plant_solver_iterations=4,
    )


def run_case(newton, ls, n_secondary, n_steps, speed, seed, device,
             samples=1024, horizon=20):
    """One closed-loop walk; the JAX script's row of numbers."""
    pm = spec.get_fast_plant_model(n_secondary=n_secondary)
    # the plant is the RICHER undecimated lower-leg model: the planner
    # must track reality it did not perfectly model
    plant = spec.get_mpc_plant_model()
    cfg = mpc_config(newton, ls, samples, horizon)
    cost_fn = rollout.make_cost_fn(pm)
    cmd = commands.make(torch.tensor([speed, 0.0], dtype=DTYPE, device=device),
                        torch.tensor(0.0, dtype=DTYPE, device=device))
    phys = engine.make_state(plant, dtype=DTYPE, device=device)
    carry = mpc_runtime.init_carry(pm, cfg, horizon, seed=seed, dtype=DTYPE,
                                   device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    carry, phys, (ctrls, sens, costs) = mpc_runtime.closed_loop(
        pm, cfg, cost_fn, carry, phys, cmd, n_steps, plant_model=plant)
    sens = sens.double().cpu().numpy()  # waits for the card
    wall = time.perf_counter() - t0

    sl = SensorSlices.from_model(pm)
    pos = sens[:, sl.pos:sl.pos + 3]
    vel = sens[:, sl.vel:sl.vel + 2]
    z = sens[:, sl.zaxis + 2]
    warm = n_steps // 4
    return {
        "budget": f"{newton}/{ls}",
        "n_secondary": n_secondary,
        "mean_vx_after_warmup": float(vel[warm:, 0].mean()),
        "mean_vel_error": float(np.abs(vel[warm:, 0] - speed).mean()),
        "mean_abs_vy": float(np.abs(vel[warm:, 1]).mean()),
        "forward_m": float(pos[-1, 0]),
        "lateral_drift_m": float(abs(pos[-1, 1])),
        "min_uprightness": float(z.min()),
        "flipped": bool(z.min() <= 0),
        "wall_s": wall,
    }


def budget_verdict(results, tolerance=TOLERANCE_MPS) -> dict:
    """The frontier criterion over the cases' rows, the first the
    reference: every mean velocity error within ``tolerance`` of the
    reference's, and no case flipped."""
    ref = results[0]
    spread = max(abs(r["mean_vel_error"] - ref["mean_vel_error"])
                 for r in results)
    upright = all(not r["flipped"] for r in results)
    return {
        "tolerance_mps": tolerance,
        "max_vel_error_spread_vs_4_8": spread,
        "all_upright": upright,
        "equivalent": spread < tolerance and upright,
    }


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--speed", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--horizon", type=int, default=20)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--out", default=os.path.join(
        _REPO, "artifacts", "torch_full_plant_budget_study.json"))
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    card = card_line(device)
    print("device:", card, flush=True)
    results = []
    for newton, ls, nsec in CASES:
        print(f"case budget={newton}/{ls} n_secondary={nsec} ...", flush=True)
        r = run_case(newton, ls, nsec, args.steps, args.speed, args.seed,
                     device, args.samples, args.horizon)
        print(json.dumps(r), flush=True)
        results.append(r)
    verdict = budget_verdict(results)
    report = {
        "device": card,
        "protocol": {
            "what": "closed-loop velocity tracking, fused fast-plant "
                    "planner vs the richer undecimated plant (model "
                    "mismatch included), one closed_loop call a case",
            "steps": args.steps, "command_mps": args.speed,
            "acceptance": "mean velocity error within 0.01 m/s of the "
                          "4/8 reference, never flipped",
        },
        "cases": results,
        "verdict": verdict,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(verdict, indent=1))
    print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
