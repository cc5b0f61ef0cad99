"""Characterize the fused rollout kernel's performance bound on the card,
with the PyTorch port.

Counterpart of ``scripts/kernel_roofline.py`` for
``quadruped_gym_tpu_torch`` (B1, ``ops/csrc/rollout_kernel.cu``, on the
planning model at H=50, frame_skip 5, Newton/line-search 2/4, float32):

1. Throughput saturation curve: rollouts/s against the batch S, each S
   timed with CUDA events around ``--reps`` launches after a warm-up
   (median). A flat time per rollout once the card is full means the
   kernel is bound per rollout, not starved.
2. The TRUE bytes of the fused kernel (the JAX script's formula: the
   start state in and out once, the controls in, the costs out) and
   their fraction of the HBM rate at the best point.
3. The fraction of the FP32 peak (``utils.profiling.H100``) at the best
   point, from ``utils.profiling.cost_summary`` of the kernel's plain
   version on 4 CPU lanes over one control step (every control step runs
   the same fixed-budget work), which must equal
   ``ops.cuda_engine.rollout_flops``; beside it the plain version's
   unfused bytes, an upper bound no fused kernel moves.
4. What bounds the kernel instead: ptxas registers and spills of the
   float32 build and the blocks the occupancy API fits on an SM. (The JAX
   script's vector-issue model is a TPU's and has no counterpart here.)
5. Optional ``--trace``: one launch at the best S under
   ``utils.profiling.trace`` (a Chrome trace).

Writes ``artifacts/torch_kernel_roofline.json`` (or ``--out``); the JAX
script's ``artifacts/kernel_roofline.json`` is never touched. On the card
unless ``--cpu`` (the plain version: only for tiny ``--samples``).

Run:  python scripts/torch_kernel_roofline.py [--trace] [--reps 10]
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
from quadruped_gym_tpu_torch.ops import _build, cuda_engine  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine  # noqa: E402
from quadruped_gym_tpu_torch.solvers import rollout  # noqa: E402
from quadruped_gym_tpu_torch.tasks import commands  # noqa: E402
from quadruped_gym_tpu_torch.utils import profiling  # noqa: E402

HOLD = [0.0, 0.0, -0.5] * 4
H, FRAME_SKIP = 50, 5
BUDGET = (2, 4)  # Newton passes, line-search steps
SAMPLES = (1024, 4096, 16384, 32768, 65536)
COST_LANES = 4


def true_bytes(m, S: int, horizon: int) -> int:
    """Bytes the fused kernel must move for S rollouts (the JAX script's
    formula, float32): the start state in and out once, the controls in,
    the costs out."""
    state_bytes = 4 * (m.nq + m.nv + m.na + 1 + m.nsensordata)
    return S * (horizon * m.nu * 4 + 2 * state_bytes + 4)


def kernel_cost(m, S: int, horizon: int, budget=BUDGET):
    """(the roofline of S fused rollouts, the plain version's unfused bytes
    a rollout step). Operations: ``profiling.cost_summary`` of the
    kernel's plain version over one control step on ``COST_LANES`` CPU
    lanes (held equal to ``rollout_flops``), scaled to S x horizon (every
    control step runs the same fixed-budget work); bytes: the kernel's
    true traffic (``true_bytes``)."""
    dt, cpu = torch.float32, torch.device("cpu")
    gen = torch.Generator(device=cpu)
    gen.manual_seed(0)
    prev = torch.tensor(HOLD, dtype=dt)
    noise = torch.randn((COST_LANES, 1, m.nu), generator=gen, dtype=dt)
    cs = profiling.cost_summary(
        cuda_engine.fused_rollout_cost_reference, m,
        engine.make_state(m, dtype=dt, device=cpu),
        torch.clamp(prev + 0.2 * noise, -1.0, 1.0),
        commands.make(torch.tensor([0.2, 0.0], dtype=dt),
                      torch.tensor(0.0, dtype=dt)),
        prev, FRAME_SKIP, *budget)
    ops_step = cs.flops / COST_LANES
    want = cuda_engine.rollout_flops(m, 1, FRAME_SKIP, *budget)
    if ops_step != want:
        raise AssertionError(f"cost_summary counts {ops_step} operations a "
                             f"rollout step, rollout_flops {want}")
    cost = profiling.roofline(ops_step * horizon * S,
                              true_bytes(m, S, horizon))
    return cost, cs.bytes_accessed / COST_LANES


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--samples", type=int, nargs="+", default=list(SAMPLES))
    p.add_argument("--horizon", type=int, default=H)
    p.add_argument("--reps", type=int, default=10,
                   help="timed launches at each S (median)")
    p.add_argument("--trace", nargs="?", default=None,
                   const=os.path.join(_REPO, "runs", "torch_trace_fused"),
                   help="write a trace of one launch at the best S here")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    p.add_argument("--out", default=os.path.join(
        _REPO, "artifacts", "torch_kernel_roofline.json"))
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    card = card_line(device)
    print("device:", card, flush=True)
    dt = torch.float32
    m = spec.get_planning_model()
    horizon = args.horizon
    cfg = rollout.RolloutConfig(horizon=horizon, frame_skip=FRAME_SKIP)
    cost_fn = rollout.make_cost_fn(m)
    state = engine.make_state(m, dtype=dt, device=device)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=dt, device=device),
                        torch.tensor(0.0, dtype=dt, device=device))
    prev = torch.tensor(HOLD, dtype=dt, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(time.time_ns() % 2**32 if args.seed is None
                    else args.seed)

    def score(seqs):
        return rollout.lane_batched_rollout_cost(
            m, cfg, cost_fn, state, seqs, cmd, prev,
            newton_iterations=BUDGET[0], ls_iterations=BUDGET[1],
            engine_impl="fused")

    def make_seqs(S):
        noise = torch.randn((S, horizon, m.nu), generator=gen, dtype=dt,
                            device=device)
        return torch.clamp(prev + 0.2 * noise, -1.0, 1.0)

    def seconds_per_solve(seqs):
        score(seqs)  # warm-up (and the kernel build at the first S)
        ts = []
        for _ in range(args.reps):
            if device.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                score(seqs)
                e1.record()
                torch.cuda.synchronize(device)
                ts.append(e0.elapsed_time(e1) / 1e3)
            else:
                t0 = time.perf_counter()
                score(seqs)
                ts.append(time.perf_counter() - t0)
        return float(np.median(ts))

    # 1. saturation curve
    curve = []
    for S in args.samples:
        t = seconds_per_solve(make_seqs(S))
        curve.append({"samples": S, "device_s": t, "rollouts_per_s": S / t})
        print(curve[-1], flush=True)
    best = max(curve, key=lambda r: r["rollouts_per_s"])
    S_ref, t_ref = best["samples"], best["device_s"]

    # 2-3. the fused kernel's true traffic and the plain version's
    # operations at the best point
    bound, unfused_step = kernel_cost(m, S_ref, horizon)
    nbytes = bound.bytes_accessed
    hbm_frac = bound.mem_time_s / t_ref
    flop_frac = bound.flop_time_s / t_ref

    # 4. registers, spills and occupancy of the float32 build
    kernel = {}
    if device.type == "cuda":
        geo = cuda_engine.launch_geometry(cuda_engine.model_slots(m), dt,
                                          S_ref)
        kernel = cuda_engine.kernel_info(cuda_engine.KERNEL_SOURCE, dt,
                                         geo.threads, geo.smem_bytes,
                                         geo.split)
        kernel.update(grid=geo.grid, ptxas=_build.ptxas_report(
            cuda_engine.KERNEL_SOURCE, "float32"))

    report = {
        "device": card,
        "config": {"model": "planning", "horizon": horizon,
                   "frame_skip": FRAME_SKIP, "budget": list(BUDGET),
                   "dtype": "float32", "reps": args.reps},
        "saturation_curve": curve,
        "best": best,
        "bounds_at_best": {
            "flop_fraction_of_f32_peak": flop_frac,
            "hbm_fraction_true_traffic": hbm_frac,
            "true_hbm_bytes_per_solve": int(nbytes),
            "operations_per_rollout": bound.flops / S_ref,
            "unfused_bytes_per_rollout": unfused_step * horizon,
            "bound_s": bound.roofline_s,
            "bound_by": "operations" if bound.bound == "compute" else "bytes",
            "peaks": {"fp32_flops": profiling.H100.peak_flops_f32,
                      "hbm_bytes": profiling.H100.peak_hbm_bytes},
        },
        "kernel": kernel,
    }

    if args.trace:
        seqs = make_seqs(S_ref)
        score(seqs)
        with profiling.trace(args.trace):
            score(seqs)
        report["trace_dir"] = args.trace
        print("trace written to", args.trace)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    print("wrote", args.out)
    return report


if __name__ == "__main__":
    main()
