"""Export a params-only policy artifact from a training checkpoint, with
the PyTorch port.

Counterpart of ``scripts/export_policy.py`` for
``quadruped_gym_tpu_torch``. The trainer persists the whole train state
(network, Adam moments, env state, generator) in ``<run>/policy``; the
artifact is the policy network's ``state_dict`` alone, in the port's
checkpoint layout, with the trainer's iteration as its step. It reads
back through ``rl.evaluate.load_policy`` (and so through
``scripts/torch_eval_report.py``). The network is loaded on the card
unless ``--cpu`` is given.

Run:  python scripts/torch_export_policy.py --ckpt runs/ppo/policy \
          --out runs/ppo/policy_params [--cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quadruped_gym_tpu_torch._device import resolve_device  # noqa: E402
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.rl import evaluate  # noqa: E402
from quadruped_gym_tpu_torch.runtime import checkpoint  # noqa: E402
from quadruped_gym_tpu_torch.tasks import walking  # noqa: E402


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", required=True, help="trainer checkpoint dir")
    p.add_argument("--out", required=True, help="artifact dir to write")
    p.add_argument("--obs-window", type=int, default=10)
    p.add_argument("--cpu", action="store_true",
                   help="load the network on the CPU instead of the card")
    args = p.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    m = spec.get_mpc_plant_model()
    env_cfg = walking.WalkingConfig(obs_window=args.obs_window,
                                    partial_obs=True)
    net = evaluate.load_policy(args.ckpt, walking.obs_size(env_cfg, m), device)
    _, step = checkpoint.read(args.ckpt)
    n = sum(v.numel() for v in net.state_dict().values())
    checkpoint.save(args.out, net, step=step)
    print(f"wrote {args.out}: {n:,} params at iteration {step}")
    return args.out


if __name__ == "__main__":
    main()
