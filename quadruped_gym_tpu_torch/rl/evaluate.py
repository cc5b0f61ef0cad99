"""Policy evaluation rollout: one episode of a policy through the gym env.

Counterpart of ``quadruped_gym_tpu/rl/evaluate.py``. Plays a policy under
the reference's fixed evaluation command (speed 0.2, heading 0) through
the gym-level env, optionally renders or records a video, and plots the
per-step rewards. As in the JAX package the eval env is the gym env's
default model (``full``: every collision geom of the robot), while the
trainer's envs step ``mpc_plant``.

Run:  python -m quadruped_gym_tpu_torch.rl.evaluate --policy runs/ppo/policy

``--policy`` is a checkpoint directory of this package's trainer (a train
state, whose leaves start with the network's) or a policy checkpoint of
the JAX package (``artifacts/walk_r5/policy_params``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..envs.gym_env import POWalkingQuadrupedEnv, WalkingQuadrupedEnv
from ..models import spec
from ..runtime import checkpoint
from ..tasks import walking
from ..utils import plot as plot_mod
from . import networks, ppo


def eval_rollout(
    net: networks.ActorCritic,
    obs_window: int = 10,
    max_time: float = 20.0,
    frame_skip: int = 10,
    render_mode=None,
    save_video: bool = False,
    video_path: str = "videos/eval.mp4",
    deterministic: bool = True,
    seed: int = 0,
    partial_obs: bool = True,
    speed: float = 0.2,
    heading: float = 0.0,
    device=None,
    dtype=torch.float32,
):
    """One policy episode through the gym-level env under a fixed command,
    the env on ``device`` (the card unless given) in ``dtype``.

    The actor reads float32 observations, as the JAX package feeds its
    float32 parameters; the stochastic actor draws from a generator on
    the network's device seeded with ``seed``. Returns a metrics dict:
    per-step rewards, the mean command tracking error (|local v_xy - cmd
    v_xy|), the mean uprightness (body z-axis z) and survival. Used by
    ``main`` below and by the trainer's per-iteration eval.
    """
    device = resolve_device(device)
    env_cls = POWalkingQuadrupedEnv if partial_obs else WalkingQuadrupedEnv
    kwargs = dict(
        max_time=max_time, frame_skip=frame_skip, render_mode=render_mode,
        save_video=save_video, video_path=video_path, device=device,
        dtype=dtype,
    )
    if partial_obs:
        kwargs["obs_window"] = obs_window
    env = env_cls(**kwargs)
    # control-step duration from the model, not a hard-coded 0.002
    step_dt = float(env.pm.timestep) * frame_skip
    # the fixed evaluation command
    env.control_inputs.set_orientation(heading)
    env.control_inputs.set_velocity_speed_alpha(speed, heading)

    p = next(net.parameters())
    gen = torch.Generator(device=p.device)
    gen.manual_seed(seed)
    obs, _ = env.reset(seed=seed)
    sl = env._sl()
    rewards_hist, track_err, upright = [], [], []
    done = False
    while not done:
        o = torch.as_tensor(np.asarray(obs, np.float32), device=p.device)
        with torch.no_grad():
            if deterministic:
                a = networks.actor_mean(net, o.to(p.dtype))
            else:
                a, _ = networks.sample_action(net, o.to(p.dtype), gen)
        action = a.cpu().numpy()
        obs, r, terminated, truncated, info = env.step(
            np.clip(action, -1.0, 1.0)
        )
        rewards_hist.append(float(r))
        v = env.data.sensordata[sl.vel : sl.vel + 2]
        track_err.append(
            float(np.linalg.norm(v - env.control_inputs.velocity[:2]))
        )
        upright.append(float(env.data.sensordata[sl.zaxis + 2]))
        if render_mode is not None or save_video:
            try:
                env.render()
            except Exception as e:  # no OpenCV on this host: keep metrics
                print(f"render unavailable ({e!r}); continuing without video")
                render_mode, save_video = None, False
        done = terminated or truncated
    env.close()
    return {
        "rewards": rewards_hist,
        "episode_return": float(sum(rewards_hist)),
        "steps": len(rewards_hist),
        "survived": len(rewards_hist) * step_dt >= max_time - 1e-6,
        "mean_tracking_error": float(np.mean(track_err)),
        "final_tracking_error": float(np.mean(track_err[-100:])),
        "mean_uprightness": float(np.mean(upright)),
        "command_speed": speed,
    }


def load_policy(policy_dir: str, obs_dim: int,
                device=None) -> networks.ActorCritic:
    """The policy network of a checkpoint, float32 on ``device``: this
    package's trainer checkpoint, whose first leaves are the network's
    ``state_dict`` at the trainer's default widths, or else a JAX policy
    checkpoint through ``convert.policy_params``."""
    from .. import convert  # convert imports this package

    device = resolve_device(device)
    arrays, _ = checkpoint.read(policy_dir)
    net = networks.ActorCritic(
        networks.NetConfig(obs_dim=obs_dim, act_dim=12,
                           hidden=ppo.PPOConfig().hidden),
        torch.float32, device)
    state = net.state_dict()
    leaves = [arrays.get(f"leaf_{i}") for i in range(len(state))]
    if all(a is not None and a.shape == tuple(v.shape)
           for a, v in zip(leaves, state.values())):
        net.load_state_dict({k: torch.as_tensor(a)
                             for k, a in zip(state, leaves)})
        return net
    return convert.policy_params(arrays, torch.float32, device)


def evaluate_model(
    policy_dir: str,
    obs_window: int = 10,
    max_time: float = 20.0,
    frame_skip: int = 10,
    render_mode=None,
    save_video: bool = False,
    video_path: str = "videos/eval.mp4",
    deterministic: bool = True,
    seed: int = 0,
    partial_obs: bool = True,
    device=None,
):
    """Restore a policy and play one episode; returns the per-step
    rewards. The observation width comes from the trainer's model
    (``mpc_plant``), as the JAX package builds its example train state
    there; the episode runs on the gym env's ``full``."""
    m = spec.get_mpc_plant_model()
    env_cfg = walking.WalkingConfig(
        max_time=max_time, frame_skip=frame_skip, obs_window=obs_window,
        partial_obs=partial_obs,
    )
    net = load_policy(policy_dir, walking.obs_size(env_cfg, m), device)
    metrics = eval_rollout(
        net,
        obs_window=obs_window,
        max_time=max_time,
        frame_skip=frame_skip,
        render_mode=render_mode,
        save_video=save_video,
        video_path=video_path,
        deterministic=deterministic,
        seed=seed,
        partial_obs=partial_obs,
        device=device,
    )
    return metrics["rewards"]


def main(argv=None, device=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--policy", required=True)
    p.add_argument("--obs-window", type=int, default=10)
    p.add_argument("--render", action="store_true")
    p.add_argument("--save-video", default=None)
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--plot", default="plots/eval_rewards.png")
    args = p.parse_args(argv)

    hist = evaluate_model(
        args.policy,
        obs_window=args.obs_window,
        render_mode="human" if args.render else (
            "rgb_array" if args.save_video else None
        ),
        save_video=bool(args.save_video),
        video_path=args.save_video or "videos/eval.mp4",
        deterministic=not args.stochastic,
        device=device,
    )
    print(f"episode return {sum(hist):.2f} over {len(hist)} steps")
    if args.plot:
        if plot_mod.have_matplotlib():
            plot_mod.plot_data_line(hist, window=20,
                                    title="Eval reward per step",
                                    save_path=args.plot)
            print(f"wrote {args.plot}")
        else:
            print(f"matplotlib not found: {args.plot} not drawn")
    return hist


if __name__ == "__main__":
    main()
