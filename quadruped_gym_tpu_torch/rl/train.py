"""PPO training entry point.

Counterpart of ``quadruped_gym_tpu/rl/train.py``, with its flags and
defaults and its workflow: an output folder holding
``rewards_continuous.csv`` (one row per policy step, the reference's
schema, written by ``native.make_reward_logger``: the C++ ring logger, or
the Python one where it cannot be built), ``policy/`` (the train state
and the iteration counter, saved every iteration, so a crashed run
resumes where it stopped), ``plots/``
(per iteration, ``reward_plot_{i}.png`` and
``reward_components_{i}.html``), and, unless ``--no-eval``, one eval
episode per iteration of the policy through the gym env
(``rl/evaluate.py``): a line of ``logs/eval_metrics.jsonl`` and a video
``videos/run_{i}.mp4``. An optional log-std-clamped fine-tune phase runs
in the same process; ``--dashboard`` serves the CSV live
(``utils/server.py``). It runs on the card unless ``main`` is given
``device="cpu"``.

The eval video needs OpenCV and the PNG plot matplotlib; without them
pass ``--no-eval-video``, and the PNG is skipped with a printed line.

``--distributed`` cuts the env batch over every rank of a
``torch.distributed`` group (``rl/distributed.py``; ``--num-envs`` is the
global count): ``parallel.multihost.initialize`` starts the group from
torchrun's variables, or the process runs as a group of one. Rank 0
alone writes the CSV, plots, eval, video and dashboard, and the
checkpoint, which holds the global state (the env state gathered from
every rank) in the single-process layout; each rank resumes from its
slice. There is no fine-tune phase under ``--distributed``, as in the JAX
trainer.

Run:  python -m quadruped_gym_tpu_torch.rl.train --output runs/ppo
      torchrun --nproc-per-node N -m quadruped_gym_tpu_torch.rl.train \
          --distributed
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import NamedTuple, Optional

from .._device import resolve_device
from ..models import spec
from ..native import make_reward_logger
from ..parallel import DATA_AXIS, make_mesh, multihost
from ..parallel.mesh import group_scope
from ..runtime import checkpoint
from ..tasks import commands, walking
from ..tasks.rewards import REWARD_KEYS
from ..utils import plot as plot_mod
from ..utils import server
from ..utils.metrics import read_reward_csv
from . import distributed, evaluate, ppo


class Iteration(NamedTuple):
    index: int
    seconds: float  # host clock, from the first update to its metrics read
    metrics: ppo.UpdateMetrics  # stacked over the iteration's updates
    eval_seconds: Optional[float] = None  # host clock of the eval episode


def make_env_config(args) -> walking.WalkingConfig:
    # the reference's training env: a fixed 0.3 m/s command straight ahead,
    # or a speed drawn per reset from [--min-speed, --max-speed]
    opts = {
        "fixed_heading_angle": 0.0,
        "fixed_velocity_angle": 0.0,
    }
    if args.min_speed is not None or args.max_speed is not None:
        opts["min_speed"] = 0.0 if args.min_speed is None else args.min_speed
        opts["max_speed"] = 0.4 if args.max_speed is None else args.max_speed
    else:
        opts["fixed_speed"] = args.fixed_speed
    return walking.WalkingConfig(
        max_time=args.max_time,
        frame_skip=args.frame_skip,
        obs_window=args.obs_window,
        partial_obs=not args.full_obs,
        random_controls=True,
        reset_options=commands.SampleOptions.from_dict(opts),
        max_contacts=args.max_contacts,
        solver_iterations=args.solver_iterations,
    )


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--output", default="runs/ppo")
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--timesteps-per-iteration", type=int, default=500_000)
    p.add_argument("--num-envs", type=int, default=2048)
    p.add_argument("--num-steps", type=int, default=32)
    p.add_argument("--max-time", type=float, default=20.0)
    p.add_argument("--frame-skip", type=int, default=10)
    p.add_argument("--obs-window", type=int, default=10)
    p.add_argument("--full-obs", action="store_true")
    p.add_argument("--max-contacts", type=int, default=12)
    p.add_argument("--solver-iterations", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fixed-speed", type=float, default=0.3,
                   help="fixed command speed per reset")
    p.add_argument("--min-speed", type=float, default=None,
                   help="sample the command speed uniformly in "
                        "[min-speed, max-speed] per reset instead of "
                        "fixing it")
    p.add_argument("--max-speed", type=float, default=None)
    p.add_argument("--dashboard", action="store_true",
                   help="serve live metrics on :8050")
    p.add_argument("--lane-physics", action="store_true",
                   help="step the env physics on the batch-minor leg "
                        "engine instead of the oracle engine")
    p.add_argument("--finetune-iterations", type=int, default=0,
                   help="after the main iterations, continue this many "
                        "more with log_std clamped, in the same process")
    p.add_argument("--finetune-log-std-max", type=float, default=-1.2,
                   help="log-std ceiling for the fine-tune phase "
                        "(sigma <= e^x; -1.2 -> 0.30)")
    p.add_argument("--log-std-max", type=float, default=None,
                   help="clamp the policy log-std from above after each "
                        "minibatch step")
    p.add_argument("--no-eval", action="store_true",
                   help="skip the per-iteration eval rollout (one "
                        "episode of the policy through the gym env on the "
                        "full model, max-time long)")
    p.add_argument("--no-eval-video", action="store_true",
                   help="eval without recording videos/run_{i}.mp4")
    p.add_argument("--video-every", type=int, default=1,
                   help="record the eval video only every Nth iteration")
    p.add_argument("--distributed", action="store_true",
                   help="cut the env batch over every rank of the "
                        "process group (torchrun's variables; else this "
                        "process alone)")
    return p


def main(argv=None, device=None):
    """Train; returns (train_state, [Iteration of each iteration run]).
    Under ``--distributed`` the train state is this rank's."""
    args = _parser().parse_args(argv)
    device = resolve_device(device)
    with group_scope():
        return _train(args, device)


def _train(args, device):
    m = spec.get_mpc_plant_model()
    env_cfg = make_env_config(args)
    cfg = ppo.PPOConfig(num_envs=args.num_envs, num_steps=args.num_steps,
                        lane_physics=args.lane_physics,
                        log_std_max=args.log_std_max)
    mesh, update = None, None
    if args.distributed:
        multihost.initialize(device=device)
        mesh = make_mesh((DATA_AXIS,), device=device)
        ts = distributed.init_distributed_train_state(
            m, env_cfg, cfg, args.seed, mesh, device=device)
        update = distributed.make_distributed_update(m, env_cfg, cfg, mesh)
    else:
        ts = ppo.init_train_state(m, env_cfg, cfg, args.seed, device=device)
    lead = mesh is None or mesh.get_rank() == 0  # writes the files

    out = args.output
    if lead:
        os.makedirs(os.path.join(out, "logs"), exist_ok=True)
        os.makedirs(os.path.join(out, "plots"), exist_ok=True)
    ckpt_dir = os.path.join(out, "policy")
    start_iter = 0
    if checkpoint.exists(ckpt_dir):  # crash resume
        if mesh is None:
            ts, step = checkpoint.restore(ckpt_dir, ts)
        else:
            ts, step = distributed.restore(ckpt_dir, ts, mesh)
        start_iter = int(step or 0)
        print(f"resumed from {ckpt_dir} at iteration {start_iter}",
              flush=True)

    csv_path = os.path.join(out, "rewards_continuous.csv")
    # the native C++ ring logger where g++ builds it, else the Python one
    logger = make_reward_logger(csv_path, REWARD_KEYS) if lead else None
    if args.dashboard and lead:
        server.launch_dash(csv_path, block=False)
        print("dashboard on :8050", flush=True)
    updates_per_iter = max(1, args.timesteps_per_iteration // cfg.batch_size)

    # the main run, then (optionally) the log_std-clamped fine-tune; none
    # under --distributed, as in the JAX trainer
    plan = [(start_iter + i, cfg, "") for i in range(args.iterations)]
    cfg_ft = dataclasses.replace(cfg, log_std_max=args.finetune_log_std_max)
    base = start_iter + args.iterations
    if mesh is None:
        plan += [(base + i, cfg_ft,
                  f" [finetune log_std<={args.finetune_log_std_max}]")
                 for i in range(args.finetune_iterations)]

    history = []
    try:
        for it, cfg_it, phase_tag in plan:
            t0 = time.perf_counter()
            ts, metrics = ppo.train_chunk(m, env_cfg, cfg_it, ts,
                                          updates_per_iter, update)
            # (updates, num_steps, 11) -> one CSV row per policy step
            comp = metrics.reward_components.reshape(
                -1, len(REWARD_KEYS)).cpu().numpy()  # waits for the card
            dt = time.perf_counter() - t0
            steps_done = updates_per_iter * cfg.batch_size
            saved = ts if mesh is None else distributed.gather(ts, mesh)
            if lead:
                logger.log_many(it * updates_per_iter * cfg.num_steps, comp)
                checkpoint.save(ckpt_dir, saved, step=it + 1)
            print(
                f"iter {it}: {steps_done} steps in {dt:.1f}s "
                f"({steps_done / dt:,.0f} steps/s), mean step reward "
                f"{float(metrics.mean_reward.mean()):.2f}, "
                f"kl {float(metrics.approx_kl[-1]):.4f}{phase_tag}",
                flush=True,
            )
            eval_s = None
            if lead:
                logger.flush()
                _plots(out, csv_path, it)
                if not args.no_eval:
                    t0 = time.perf_counter()
                    _eval(args, out, ts, it, start_iter, device)
                    eval_s = time.perf_counter() - t0
            history.append(Iteration(it, dt, metrics, eval_s))
    finally:
        if logger is not None:
            logger.close()
    print("done", flush=True)
    return ts, history


def _plots(out: str, csv_path: str, it: int) -> None:
    """The iteration's reward plots from the whole CSV so far."""
    _, totals, comp, keys = read_reward_csv(csv_path)
    png = os.path.join(out, "plots", f"reward_plot_{it}.png")
    if plot_mod.have_matplotlib():
        plot_mod.plot_data_line(totals, window=50, title="Mean step reward",
                                save_path=png)
    else:
        print(f"  matplotlib not found: {png} not drawn", flush=True)
    plot_mod.plot_reward_components(
        comp, keys,
        os.path.join(out, "plots", f"reward_components_{it}.html"))


def _eval(args, out: str, ts: ppo.TrainState, it: int, start_iter: int,
          device) -> None:
    """One eval episode of the policy: a fresh gym env under the fixed
    0.2 m/s command, the deterministic actor, a video every
    ``--video-every`` iterations (and the last); its metrics appended to
    ``logs/eval_metrics.jsonl``."""
    os.makedirs(os.path.join(out, "videos"), exist_ok=True)
    want_video = not args.no_eval_video and (
        it % args.video_every == 0
        or it == start_iter + args.iterations - 1
    )
    em = evaluate.eval_rollout(
        ts.net,
        obs_window=args.obs_window,
        max_time=args.max_time,
        frame_skip=args.frame_skip,
        partial_obs=not args.full_obs,
        save_video=want_video,
        video_path=os.path.join(out, "videos", f"run_{it}.mp4"),
        seed=args.seed + it,
        device=device,
    )
    em.pop("rewards")
    em["iteration"] = it
    with open(os.path.join(out, "logs", "eval_metrics.jsonl"), "a") as f:
        f.write(json.dumps(em) + "\n")
    print(
        f"  eval: return {em['episode_return']:.1f}, "
        f"{em['steps']} steps, survived={em['survived']}, "
        f"track_err {em['mean_tracking_error']:.3f} m/s, "
        f"upright {em['mean_uprightness']:.3f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
