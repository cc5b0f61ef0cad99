"""Per-solve latency of the fused rollout kernel at small batch (the MPC
real-time regime), with the PyTorch port.

Counterpart of ``scripts/latency_sweep.py`` for ``quadruped_gym_tpu_torch``,
on the card unless ``--cpu`` is given: K back-to-back solves (B1,
``ops/csrc/rollout_kernel.cu``, through ``lane_batched_rollout_cost(
engine_impl="fused")``; planning model, H=50, frame_skip 5, Newton/
line-search 2/4, float32) with one synchronise at the end, each solve's
controls moved by its own costs so that no launch repeats the last one;
the median of 3 repetitions from freshly perturbed controls, after one
untimed solve. The JAX script's ``block`` axis (a TPU tile) has no
counterpart: the launch geometry is ``cuda_engine.launch_geometry``'s,
and each row reports its block size, grid and warps a block instead.

Run:  python scripts/torch_latency_sweep.py [--k 20] [--cpu]
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
from quadruped_gym_tpu_torch.ops import cuda_engine  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine  # noqa: E402
from quadruped_gym_tpu_torch.solvers import rollout  # noqa: E402
from quadruped_gym_tpu_torch.tasks import commands  # noqa: E402

HOLD = np.array([0.0, 0.0, -0.5] * 4)
DTYPE = torch.float32
K = 20  # solves a timed repetition
SAMPLES = (1024, 2048, 4096, 8192, 16384)
REPS = 3


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, nargs="+", default=list(SAMPLES))
    p.add_argument("--horizon", type=int, default=50)
    p.add_argument("--k", type=int, default=K,
                   help="back-to-back solves a timed repetition")
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the controls (default: the clock)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    rng = np.random.default_rng(time.time_ns() if args.seed is None
                                else args.seed)
    card = card_line(device)
    print(f"device: {card}", flush=True)
    m = spec.get_planning_model()
    H = args.horizon
    cost_fn = rollout.make_cost_fn(m)
    cfg = rollout.RolloutConfig(horizon=H, frame_skip=5)
    state = engine.make_state(m, dtype=DTYPE, device=device)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=DTYPE, device=device),
                        torch.tensor(0.0, dtype=DTYPE, device=device))
    prev = torch.as_tensor(HOLD, dtype=DTYPE, device=device)
    nslot = cuda_engine.model_slots(m)

    def score(seqs):
        return rollout.lane_batched_rollout_cost(
            m, cfg, cost_fn, state, seqs, cmd, prev, newton_iterations=2,
            ls_iterations=4, engine_impl="fused")

    def scan_k(seqs):
        total = None
        for _ in range(args.k):
            c = score(seqs)
            # feed the costs back into the controls so that no solve
            # repeats the last one
            seqs = torch.clamp(seqs + 1e-6 * c[:, None, None], -1.0, 1.0)
            total = c.sum() if total is None else total + c.sum()
        return total

    def noise(shape, scale):
        return torch.as_tensor(scale * rng.standard_normal(shape),
                               dtype=DTYPE, device=device)

    results = []
    for S in args.samples:
        seqs0 = torch.clamp(prev + noise((S, H, m.nu), 0.2), -1.0, 1.0)
        score(seqs0)  # untimed (the kernel's build at the first S)
        sync()
        ts = []
        for _ in range(REPS):
            s2 = torch.clamp(seqs0 + noise(tuple(seqs0.shape), 1e-4), -1.0,
                             1.0)
            sync()
            t0 = time.perf_counter()
            total = scan_k(s2)
            sync()
            ts.append(time.perf_counter() - t0)
        if not bool(torch.isfinite(total)):
            raise RuntimeError(f"non-finite costs at S={S}")
        wall = float(np.median(ts))
        geo = cuda_engine.launch_geometry(nslot, DTYPE, S)
        row = {"samples": S, "threads": geo.threads, "grid": geo.grid,
               "warps": geo.threads // 32,
               "per_solve_ms": round(wall / args.k * 1e3, 3),
               "rollouts_per_s": round(S * args.k / wall, 1)}
        results.append(row)
        print(json.dumps(row), flush=True)

    best = min(results, key=lambda r: r["per_solve_ms"])
    print("# best:", json.dumps(best))
    return {"device": card, "k": args.k, "horizon": H, "rows": results,
            "best": best}


if __name__ == "__main__":
    main()
