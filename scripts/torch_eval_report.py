"""Walking-policy evaluation report under the REFERENCE's eval protocol,
with the PyTorch port.

Counterpart of ``scripts/eval_report.py`` for ``quadruped_gym_tpu_torch``,
on the card unless ``--cpu`` is given. The reference evaluates with
``deterministic=False`` (actions sampled from the policy's Gaussian, not
its mean), so the report holds BOTH modes: the stochastic one over
``--seeds``, the deterministic one at the first seed, each one episode of
``rl.evaluate.eval_rollout`` (the gym env on ``full``, float32).

``--policy`` is a checkpoint of this package's trainer or a policy
checkpoint of the JAX package (``artifacts/walk_r5/policy_params``): both
load through ``rl.evaluate.load_policy``.

Writes ``<out>/eval_report.json``:

    python scripts/torch_eval_report.py --policy runs/ppo/policy \
        --out runs/ppo/eval [--video] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from quadruped_gym_tpu_torch._device import (  # noqa: E402
    card_line, resolve_device)
from quadruped_gym_tpu_torch.models import spec  # noqa: E402
from quadruped_gym_tpu_torch.rl import evaluate as eval_mod  # noqa: E402
from quadruped_gym_tpu_torch.runtime import checkpoint  # noqa: E402
from quadruped_gym_tpu_torch.tasks import walking  # noqa: E402


def _parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--policy", required=True, help="checkpoint dir")
    p.add_argument("--out", required=True, help="artifact dir to write")
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--obs-window", type=int, default=10)
    p.add_argument("--max-time", type=float, default=20.0)
    p.add_argument("--frame-skip", type=int, default=10)
    p.add_argument("--video", action="store_true",
                   help="record one deterministic eval video")
    p.add_argument("--note", default="")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the card")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    m = spec.get_mpc_plant_model()
    env_cfg = walking.WalkingConfig(
        max_time=args.max_time, frame_skip=args.frame_skip,
        obs_window=args.obs_window, partial_obs=True,
    )
    net = eval_mod.load_policy(args.policy, walking.obs_size(env_cfg, m),
                               device)
    _, step = checkpoint.read(args.policy)

    os.makedirs(args.out, exist_ok=True)

    def run(deterministic, seed, video_path=None):
        em = eval_mod.eval_rollout(
            net,
            obs_window=args.obs_window, max_time=args.max_time,
            frame_skip=args.frame_skip, deterministic=deterministic,
            seed=seed, save_video=video_path is not None,
            video_path=video_path or "unused.mp4", device=device,
        )
        em.pop("rewards")
        em["mode"] = "deterministic" if deterministic else "stochastic"
        em["seed"] = seed
        print(json.dumps(em), flush=True)
        return em

    rows = []
    for seed in args.seeds:
        rows.append(run(False, seed))
    rows.append(run(
        True, args.seeds[0],
        video_path=os.path.join(args.out, "eval_run_det.mp4")
        if args.video else None,
    ))

    sto = [r for r in rows if r["mode"] == "stochastic"]
    report = {
        "device": card_line(device),
        "policy": args.policy,
        "trained_iterations": int(step or 0),
        "log_std": np.asarray(net.log_std.detach().cpu()).round(3).tolist(),
        "protocol": {
            "stochastic_eval": "deterministic=False, the reference's "
                               "eval protocol (eval_quadruped.py:23)",
            "command": "0.2 m/s forward, fixed heading",
            "episode_s": args.max_time,
        },
        "stochastic_summary": {
            "seeds": args.seeds,
            "episode_returns": [r["episode_return"] for r in sto],
            "all_positive": all(r["episode_return"] > 0 for r in sto),
            "mean_tracking_error": float(np.mean(
                [r["mean_tracking_error"] for r in sto])),
            "all_survived": all(r["survived"] for r in sto),
        },
        "episodes": rows,
        "note": args.note,
    }
    out = os.path.join(args.out, "eval_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
