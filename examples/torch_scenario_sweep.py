"""Domain-randomized MPC scenario sweep through the fused rollout kernel,
with the PyTorch port.

Counterpart of ``examples/scenario_sweep.py`` for
``quadruped_gym_tpu_torch``, on the card unless ``--cpu`` is given
(BASELINE config 3/5 shape): tens of thousands of scenarios, each with its
own friction, servo gains, payload, ground slope and rough terrain (a
per-scenario bump field: distinct contact geometry per scenario), scored
in ONE launch of the fused rollout kernel (``DomainParams`` lanes, H=50,
frame_skip 5, Newton/line-search 4/8, float32); then the costs are
summarized by scenario halves.

Run:  python examples/torch_scenario_sweep.py [num_scenarios] [--cpu]
"""

from __future__ import annotations

import argparse
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
from quadruped_gym_tpu_torch.solvers import rollout  # noqa: E402
from quadruped_gym_tpu_torch.tasks import commands  # noqa: E402

HORIZON, FRAME_SKIP = 50, 5
BUDGET = (4, 8)  # Newton passes, line-search steps
DTYPE = torch.float32
# the JAX example's ranges (examples/scenario_sweep.py:46-53)
DP_RANGES = dict(
    friction_range=(0.3, 0.9),
    gain_range=(0.7, 1.3),
    mass_range=(0.8, 1.8),
    tilt_range=(-0.2, 0.2),
    terrain_amp_range=(0.0, 0.02),
)
HOLD = [0.0, 0.0, -0.5] * 4


def score(m, cfg: rollout.RolloutConfig, state, seqs: torch.Tensor, cmd,
          prev: torch.Tensor, dp: spec.DomainParams) -> torch.Tensor:
    """(S,) walking costs of the scenarios: one fused launch on the card
    (the kernel's plain version for CPU tensors)."""
    return rollout.lane_batched_rollout_cost(
        m, cfg, rollout.make_cost_fn(m), state, seqs, cmd, prev,
        newton_iterations=BUDGET[0], ls_iterations=BUDGET[1],
        engine_impl="fused", dp=dp,
    )


def main(num_scenarios: int = 16384, device=None, seed: int | None = None,
         horizon: int = HORIZON) -> dict:
    """Score ``num_scenarios`` randomized scenarios twice (the first call
    builds the kernel if needed and uploads the model; the second is
    warm), each timed on the host clock around a synchronised call, and
    print the JAX example's summary. ``seed`` (default: the clock, as in
    the JAX example) seeds the generator of the scenarios and controls."""
    device = resolve_device(device)
    if seed is None:
        seed = time.time_ns() % 2**32
    m = spec.get_planning_model()
    cfg = rollout.RolloutConfig(horizon=horizon, frame_skip=FRAME_SKIP)
    state = engine.make_state(m, dtype=DTYPE, device=device)
    cmd = commands.make(torch.tensor([0.2, 0.0], dtype=DTYPE, device=device),
                        torch.tensor(0.0, dtype=DTYPE, device=device))
    prev = torch.tensor(HOLD, dtype=DTYPE, device=device)

    S = num_scenarios
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    # every rollout is its own world: friction, gains, payload, slope,
    # and rough terrain
    dp = spec.sample_domain_params(gen, S, dtype=DTYPE, **DP_RANGES)
    noise = torch.randn((S, cfg.horizon, m.nu), generator=gen, dtype=DTYPE,
                        device=device)
    seqs = torch.clamp(prev + 0.2 * noise, -1.0, 1.0)

    def timed():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        costs = score(m, cfg, state, seqs, cmd, prev, dp)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return costs, time.perf_counter() - t0

    print(f"scoring {S} randomized scenarios (H={cfg.horizon}) on "
          f"{card_line(device)}...", flush=True)
    _, t_first = timed()
    costs, t_warm = timed()

    costs = costs.double().cpu().numpy()
    fr = dp.friction.double().cpu().numpy()
    tilt = np.hypot(dp.tilt_x.double().cpu().numpy(),
                    dp.tilt_y.double().cpu().numpy())
    amp = dp.terrain_amp.double().cpu().numpy()
    print(f"first call {t_first:.1f}s (kernel build and model upload), "
          f"warm {t_warm * 1e3:.0f} ms -> {S / t_warm:,.0f} "
          f"scenario-rollouts/s")
    print(f"cost: mean {costs.mean():.1f}, best {costs.min():.1f}, "
          f"worst {costs.max():.1f}")
    halves = {}
    for name, x, lo_name, hi_name in (
            ("friction", fr, "low-friction", "high-friction"),
            ("slope", tilt, "gentle-slope", "steep-slope"),
            ("terrain", amp, "smooth-terrain", "rough-terrain")):
        lo, hi = x < np.median(x), x >= np.median(x)
        halves[name] = (float(costs[lo].mean()), float(costs[hi].mean()))
        print(f"{lo_name} half mean cost {halves[name][0]:.1f} vs "
              f"{hi_name} {halves[name][1]:.1f}")
    return {"scenarios": S, "horizon": cfg.horizon, "seed": seed,
            "first_s": t_first, "warm_s": t_warm,
            "rollouts_per_s": S / t_warm, "costs": costs, "halves": halves}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("num_scenarios", nargs="?", type=int, default=16384)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    a = p.parse_args()
    main(a.num_scenarios, device="cpu" if a.cpu else None, seed=a.seed)
