"""Headline benchmark of the PyTorch/CUDA port: sampled-MPC rollouts/s on
one card at H=50.

Counterpart of ``bench.py``: the same workload through the same entry
points. Each solve scores S=65,536 rollouts of H=50 control steps x 5
physics substeps (250 contact-solved dynamics steps and the walking stage
cost each) through ``solvers.rollout.lane_batched_rollout_cost(
engine_impl="fused")``, which launches the fused whole-rollout kernel
(``ops/csrc/rollout_kernel.cu``) once. The planning plant is the
feet-only decimated-hull model at the 2/4 Newton/line-search budget; the
full plant the fast-plant model (feet, shins and ankle servos) at 4/8.
One warm-up solve, then 5 timed solves, each on its own control batch
(``prev + 0.2 N(0, 1)`` clipped to [-1, 1], from a ``torch.Generator``
seeded with ``--seed``), each synchronised before and after. Prints ONE
JSON line with ``bench.py``'s keys, plus ``card`` (the card's name and
power limit, as nvidia-smi gives them).

``bench.py``'s TPU supervisor (backend probe, child processes, retries)
and its fail-soft line have no counterpart: a failure raises and the exit
code is not 0. Its ``--block`` (a TPU tile) has none either: the launch
geometry is ``ops.cuda_engine.launch_geometry``'s.

Run:  python torch_bench.py [--plant planning|full|both] [--seed 0] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from quadruped_gym_tpu_torch._device import card_line, resolve_device
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.physics import engine
from quadruped_gym_tpu_torch.solvers import rollout
from quadruped_gym_tpu_torch.tasks import commands

BASELINE_ROLLOUTS_PER_S = 100_000.0
S = 65536  # rollouts a solve
HORIZON = 50
FRAME_SKIP = 5
ITERS = 5  # timed solves
DTYPE = torch.float32
METRIC = "mpc_rollouts_per_s_per_chip_H50"


def run_bench(plant: str, seed: int, device) -> dict:
    """One plant's JSON object: ``metric``, ``value`` (rollouts/s over the
    timed solves, host clock), ``unit``, ``vs_baseline``."""
    device = torch.device(device)
    full_plant = plant == "full"
    m = spec.get_fast_plant_model() if full_plant else spec.get_planning_model()
    newton, ls = (4, 8) if full_plant else (2, 4)
    metric = METRIC + "_full_plant" if full_plant else METRIC
    cfg = rollout.RolloutConfig(horizon=HORIZON, frame_skip=FRAME_SKIP)
    cost_fn = rollout.make_cost_fn(m)
    state = engine.make_state(m, dtype=DTYPE, device=device)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=DTYPE, device=device),
                        torch.tensor(0.0, dtype=DTYPE, device=device))
    prev = torch.tensor([0.0, 0.0, -0.5] * 4, dtype=DTYPE, device=device)

    def score(seqs):
        return rollout.lane_batched_rollout_cost(
            m, cfg, cost_fn, state, seqs, cmd, prev,
            newton_iterations=newton, ls_iterations=ls, engine_impl="fused")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    all_seqs = [
        torch.clamp(prev + 0.2 * torch.randn(
            (S, HORIZON, m.nu), generator=gen, dtype=DTYPE, device=device),
            -1.0, 1.0)
        for _ in range(ITERS + 1)
    ]
    score(all_seqs[-1])  # warm-up (and the kernel's build)
    sync()
    dt = 0.0
    for seqs in all_seqs[:ITERS]:
        sync()
        t0 = time.perf_counter()
        costs = score(seqs)
        sync()
        dt += time.perf_counter() - t0
        if not bool(torch.isfinite(costs).all()):
            raise RuntimeError(f"{plant}: non-finite rollout costs")
    rps = S * ITERS / dt
    return {
        "metric": metric,
        "value": round(rps, 1),
        "unit": "rollouts/s",
        "vs_baseline": round(rps / BASELINE_ROLLOUTS_PER_S, 4),
    }


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument(
        "--plant", choices=("planning", "full", "both"), default="both",
        help="planning: feet-only decimated hulls at the 2/4 newton/"
        "linesearch budget (headline). full: the lower-leg collision plant "
        "(feet+shins+ankle servos) at 4/8. both (default): one JSON line "
        "carrying both numbers.")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the control batches")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernel's plain version)")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    both = args.plant == "both"
    head = run_bench("planning" if both else args.plant, args.seed, device)
    if both:
        full = run_bench("full", args.seed, device)
        head["full_plant_rollouts_per_s"] = full["value"]
        head["full_plant_vs_baseline"] = full["vs_baseline"]
    head["card"] = card_line(device)
    print(json.dumps(head), flush=True)
    return head


if __name__ == "__main__":
    main()
