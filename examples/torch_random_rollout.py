"""Exploration smoke test (the reference's ``quadruped_model.ipynb``) with
the PyTorch port: a 10 s rollout under random controls resampled at 10 Hz,
a joint-angle plot, an optional video.

Counterpart of ``examples/random_rollout.py`` for
``quadruped_gym_tpu_torch``, on the card unless ``--cpu`` is given: the
oracle engine on the ``mpc_plant`` model (feet, shins and ankle servos;
12 contacts, 4 Newton passes) at 500 Hz, float32, the controls drawn
uniformly in [-1, 1] from a ``torch.Generator`` seeded with 0 (the
JAX example's ``PRNGKey(0)``), the 33 sensors of every substep kept.
The PNG needs matplotlib (without it the plot is skipped with a printed
line); ``--video`` draws the wireframe renderer (``envs/rendering.py``)
and needs OpenCV.

Run:  python examples/torch_random_rollout.py [--seconds 10]
          [--video videos/simulation.mp4] [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quadruped_gym_tpu_torch._device import resolve_device  # noqa: E402
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.physics import engine  # noqa: E402
from quadruped_gym_tpu_torch.utils import plot as plot_mod  # noqa: E402

MAX_CONTACTS, SOLVER_ITERATIONS = 12, 4
RESAMPLE_S = 0.1  # a new random control every 0.1 s (10 Hz)


def chunk(m, state: engine.State, ctrl: torch.Tensor, n: int):
    """(state after ``n`` physics steps under ``ctrl``, the (n, 33)
    sensors each step read): the JAX example's jitted scan."""
    sens = []
    for _ in range(n):
        state = engine.step(m, state, ctrl, max_contacts=MAX_CONTACTS,
                            solver_iterations=SOLVER_ITERATIONS)
        sens.append(state.sensordata)
    return state, torch.stack(sens)


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--video", default=None)
    p.add_argument("--plot", default="plots/joint_angles.png")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def main(argv=None) -> dict:
    """Returns the (steps, 33) sensors, the base position after each
    chunk and the final base height."""
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    dt = torch.float32
    m = spec.get_mpc_plant_model()
    state = engine.make_state(m, dtype=dt, device=device)

    # random ctrl resampled at 10 Hz (notebook cell 1), physics at 500 Hz
    resample_every = int(RESAMPLE_S / m.timestep)
    n_chunks = int(args.seconds / RESAMPLE_S)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)

    sens_hist, qpos_hist, times = [], [], []
    for _ in range(n_chunks):
        u = torch.rand((m.nu,), generator=gen, dtype=dt, device=device)
        state, sens = chunk(m, state, 2.0 * u - 1.0, resample_every)
        sens_hist.append(sens.double().cpu().numpy())
        qpos_hist.append(state.qpos.double().cpu().numpy())
        times.append(float(state.time))
    sens_hist = np.concatenate(sens_hist)  # (steps, 33)
    print(f"rolled out {sens_hist.shape[0]} physics steps on {device}; "
          f"final base height {qpos_hist[-1][2]:.3f} m")

    # joint-angle traces (notebook cell 2)
    if plot_mod.have_matplotlib():
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(4, 3, figsize=(12, 8), sharex=True)
        t = np.arange(sens_hist.shape[0]) * m.timestep
        for j in range(12):
            ax = axes[j // 3][j % 3]
            ax.plot(t, sens_hist[:, j], lw=0.7)
            ax.set_title(m.sensor_names[j] if j < len(m.sensor_names)
                         else f"joint {j}", fontsize=8)
        fig.tight_layout()
        os.makedirs(os.path.dirname(args.plot) or ".", exist_ok=True)
        fig.savefig(args.plot, dpi=120)
        plt.close(fig)
        print(f"wrote {args.plot}")
    else:
        print(f"matplotlib not found: {args.plot} not drawn")

    if args.video:
        from quadruped_gym_tpu_torch.envs.rendering import HostRenderer

        # one frame per chunk, from the states the rollout ended each
        # chunk in (the JAX example re-simulates the same states)
        os.makedirs(os.path.dirname(args.video) or ".", exist_ok=True)
        r = HostRenderer(m, width=640, height=480, save_video=True,
                         video_path=args.video)
        r.reset_timers()
        for qpos, t in zip(qpos_hist, times):
            r.sync(qpos, time_=t)
            r.render(mode="rgb_array")
        r.close()
        print(f"wrote {args.video}")
    return {"sensors": sens_hist, "qpos": np.stack(qpos_hist),
            "final_height": float(qpos_hist[-1][2])}


if __name__ == "__main__":
    main()
