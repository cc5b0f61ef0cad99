"""Time the pieces of the real-time MPC step, with the PyTorch port: (a) one
oracle-engine ``control_step`` (the predictor / plant twin) at the
planner's budget, (a2) the same at the plant's budget, (b) one MPPI
``plan_and_act`` solve. Separates which part of the 100 Hz budget each
consumes.

Counterpart of ``scripts/latency_parts.py`` for ``quadruped_gym_tpu_torch``,
on the card unless ``--cpu`` is given. The JAX script times a K-step
on-device scan; here each part runs K times back to back on the host
clock with one synchronise at the end (the port has no scan: the host
issues every launch), after one untimed call, and from inputs perturbed
before each of the ``--reps`` repetitions so that no call repeats the
last one. Each part prints one JSON line keyed as the JAX script's, then
the sum. The planning model, float32:

- (a) ``RolloutConfig``'s budgets: 12 contacts, 8 Newton passes;
- (a2) the plant's: ``MPCConfig.plant_max_contacts`` (24) and the model's
  own budget (100 passes; in float32 the solver never meets its
  tolerance, so it runs them all);
- (b) MPPI over the fused rollout kernel, 1,024 samples, H=50,
  Newton/line-search 2/4.

Run:  python scripts/torch_latency_parts.py [--k 20] [--reps 3] [--cpu]
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

HOLD = np.array([0.0, 0.0, -0.5] * 4)
K = 20
DTYPE = torch.float32


def perturbed(x, rng, scale=1e-5):
    """``x`` (a tensor or a tuple of them, nested) with ``scale`` times
    standard normals added to every floating tensor; anything else (a
    generator, an integer tensor) as it is."""
    if isinstance(x, torch.Tensor):
        if not x.is_floating_point():
            return x
        return x + torch.as_tensor(scale * rng.standard_normal(tuple(x.shape)),
                                   dtype=x.dtype, device=x.device)
    if isinstance(x, tuple):
        vals = [perturbed(v, rng, scale) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def synchronizer(device):
    """A function that waits for ``device`` (nothing to wait for on the
    CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def timed_scan(body, init, rng, device, k=K, reps=3):
    """Milliseconds per call of ``body`` (carry -> carry) over ``k``
    back-to-back calls with one synchronise at the end: the median of
    ``reps`` repetitions, each from ``init`` perturbed anew, after one
    untimed call (the kernel's build and the model's upload)."""
    sync = synchronizer(device)
    body(init)
    sync()
    ts = []
    for _ in range(reps):
        c = perturbed(init, rng)
        sync()
        t0 = time.perf_counter()
        for _ in range(k):
            c = body(c)
        sync()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / k * 1e3


def mpc_config(samples=1024, horizon=50) -> mpc_runtime.MPCConfig:
    """The JAX script's planner: MPPI, ``samples`` rollouts of ``horizon``
    control steps through the fused kernel at 2/4, one iteration."""
    return mpc_runtime.MPCConfig(
        solver="mppi",
        mppi=mppi.MPPIConfig(
            num_samples=samples, sigma=0.2, iterations=1,
            rollout=rollout.RolloutConfig(horizon=horizon, frame_skip=5),
            lane=True, lane_engine_impl="fused",
            lane_newton_iterations=2, lane_ls_iterations=4,
        ),
        plant_frame_skip=5,
    )


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--k", type=int, default=K,
                   help="back-to-back calls a timed repetition")
    p.add_argument("--reps", type=int, default=3,
                   help="timed repetitions of each part (median)")
    p.add_argument("--samples", type=int, default=1024)
    p.add_argument("--horizon", type=int, default=50)
    p.add_argument("--seed", type=int, default=None,
                   help="seed of the perturbations (default: the clock)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    rng = np.random.default_rng(time.time_ns() if args.seed is None
                                else args.seed)
    m = spec.get_planning_model()
    cost_fn = rollout.make_cost_fn(m)
    cfg = mpc_config(args.samples, args.horizon)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=DTYPE, device=device),
                        torch.tensor(0.0, dtype=DTYPE, device=device))
    st = engine.make_state(m, dtype=DTYPE, device=device)
    ctrl = torch.as_tensor(HOLD, dtype=DTYPE, device=device)
    rcfg = cfg.rollout
    report = {"device": card_line(device), "k": args.k, "parts": []}
    print(f"device: {report['device']}", flush=True)

    def part(name, body, init):
        ms = timed_scan(body, init, rng, device, args.k, args.reps)
        line = {"part": name, "ms": round(ms, 3)}
        report["parts"].append(line)
        print(json.dumps(line), flush=True)
        return ms

    # (a) the oracle control_step at the planner budget (the predictor)
    ms_aos = part("aos_control_step_planner_budget", lambda phys: (
        engine.control_step(m, phys, ctrl, cfg.plant_frame_skip,
                            max_contacts=rcfg.max_contacts,
                            solver_iterations=rcfg.solver_iterations)),
        st)
    # (a2) the oracle control_step at the plant budget
    ms_aosp = part("aos_control_step_plant_budget", lambda phys: (
        engine.control_step(m, phys, ctrl, cfg.plant_frame_skip,
                            max_contacts=cfg.plant_max_contacts,
                            solver_iterations=cfg.plant_solver_iterations)),
        st)
    # (b) the MPPI solve alone
    carry0 = mpc_runtime.init_carry(m, cfg, args.horizon, seed=0,
                                    dtype=DTYPE, device=device)
    ms_solve = part(f"mppi_solve_{args.samples}xH{args.horizon}",
                    lambda c: mpc_runtime.plan_and_act(m, cfg, cost_fn, c,
                                                       st, cmd)[1],
                    carry0)
    report["sum_ms"] = round(ms_aos + ms_aosp + ms_solve, 3)
    report["note"] = ("delayed_closed_loop body = predictor oracle step + "
                      "solve + plant oracle step")
    print(json.dumps({"sum_ms": report["sum_ms"], "note": report["note"]}))
    return report


if __name__ == "__main__":
    main()
