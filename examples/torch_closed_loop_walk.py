"""Closed-loop velocity-tracking walk, planned by the fused CUDA MPC, with
the PyTorch port.

Counterpart of ``examples/closed_loop_walk.py`` for
``quadruped_gym_tpu_torch``, on the card unless ``--cpu`` is given: MPPI
over the fused whole-rollout kernel (feet-only decimated-hull planning
model, 1,024 samples, H=20, 2 iterations) controls a plant integrated by
the oracle engine with the richer lower-leg-collision model
(``mpc_plant``: 12 contacts, 4 Newton passes) — planner/plant model
mismatch included. 200 control steps (2 s of sim at 100 Hz) run as one
``mpc_runtime.closed_loop`` call, float32, which never reads the card
back until the end.

Run:  python examples/torch_closed_loop_walk.py [n_steps] [speed] [--cpu]
The JAX example's typical result (0.15 m/s command): ~0.32 m traveled
forward in 2 s, |lateral drift| < 3 cm, uprightness > 0.98 throughout.
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

from quadruped_gym_tpu_torch._device import resolve_device  # noqa: E402
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine  # noqa: E402
from quadruped_gym_tpu_torch.runtime import mpc_runtime  # noqa: E402
from quadruped_gym_tpu_torch.solvers import mppi, rollout  # noqa: E402
from quadruped_gym_tpu_torch.tasks import commands  # noqa: E402
from quadruped_gym_tpu_torch.tasks.rewards import SensorSlices  # noqa: E402

DTYPE = torch.float32


def mpc_config() -> mpc_runtime.MPCConfig:
    """The planner and the plant budgets of the walk."""
    return mpc_runtime.MPCConfig(
        solver="mppi",
        mppi=mppi.MPPIConfig(
            num_samples=1024, sigma=0.25, temperature=0.5, iterations=2,
            lane=True, lane_engine_impl="fused",
            rollout=rollout.RolloutConfig(horizon=20, frame_skip=5),
        ),
        plant_frame_skip=5, plant_max_contacts=12,
        plant_solver_iterations=4,
    )


def setup(device, seed: int, speed: float = 0.15):
    """(planning model, plant model, config, cost_fn, command, carry,
    plant state) of the walk on ``device``, float32; the carry's noise
    stream seeded with ``seed``."""
    pm = spec.get_planning_model()
    plant = spec.get_mpc_plant_model()
    cfg = mpc_config()
    cmd = commands.make(torch.tensor([speed, 0.0], dtype=DTYPE, device=device),
                        torch.tensor(0.0, dtype=DTYPE, device=device))
    carry = mpc_runtime.init_carry(pm, cfg, cfg.rollout.horizon, seed=seed,
                                   dtype=DTYPE, device=device)
    phys = engine.make_state(plant, dtype=DTYPE, device=device)
    return pm, plant, cfg, rollout.make_cost_fn(pm), cmd, carry, phys


def summary(pm, sens: torch.Tensor, n_steps: int, speed: float) -> dict:
    """The walk's numbers from the plant's sensors, printed as the JAX
    example prints them."""
    sl = SensorSlices.from_model(pm)
    sens = sens.double().cpu().numpy()
    pos = sens[:, sl.pos:sl.pos + 3]
    vel = sens[:, sl.vel:sl.vel + 2]
    z = sens[:, sl.zaxis + 2]
    warm = n_steps // 4
    out = {"forward_m": float(pos[-1][0]), "sideways_m": float(pos[-1][1]),
           "mean_vx": float(vel[warm:, 0].mean()),
           "mean_abs_vy": float(np.abs(vel[warm:, 1]).mean()),
           "upright_min": float(z.min()),
           "height_min": float(pos[:, 2].min()),
           "height_max": float(pos[:, 2].max())}
    print(f"commanded +x {speed} m/s; traveled "
          f"({out['forward_m']:+.3f}, {out['sideways_m']:+.3f}) m")
    print(f"mean local vx after warmup {out['mean_vx']:+.3f}, "
          f"mean |vy| {out['mean_abs_vy']:.3f}")
    print(f"uprightness min {out['upright_min']:.3f} "
          f"(never flipped: {out['upright_min'] > 0})")
    print(f"body height {out['height_min']:.3f} - {out['height_max']:.3f} m")
    return out


def main(n_steps: int = 200, speed: float = 0.15, device=None,
         seed: int | None = None) -> dict:
    """Walk ``n_steps`` control steps; returns the summary's numbers with
    the trajectories (``ctrls``, ``sens``, ``costs``), the final ``carry``
    and plant state ``phys``, and ``wall_s`` (host clock, synchronised at
    the end). ``seed`` defaults to the clock, as in the JAX example."""
    device = resolve_device(device)
    if seed is None:
        seed = int(time.time())
    pm, plant, cfg, cost_fn, cmd, carry, phys = setup(device, seed, speed)
    print(f"walking {n_steps} control steps "
          f"({n_steps * cfg.plant_frame_skip * plant.timestep:.1f} s sim) "
          f"on {device}...", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    carry, phys, (ctrls, sens, costs) = mpc_runtime.closed_loop(
        pm, cfg, cost_fn, carry, phys, cmd, n_steps, plant_model=plant)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    print(f"done in {wall:.1f} s wall")
    out = summary(pm, sens, n_steps, speed)
    out.update(steps=n_steps, wall_s=wall, seed=seed, ctrls=ctrls, sens=sens,
               costs=costs, carry=carry, phys=phys)
    return out


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_steps", nargs="?", type=int, default=200)
    p.add_argument("speed", nargs="?", type=float, default=0.15)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    a = p.parse_args()
    main(a.n_steps, a.speed, device="cpu" if a.cpu else None, seed=a.seed)
