"""Writes a bank of start states for the MPC traffic: the robot walking
under a trained policy, stepped by the plain reference in float64.

    python3 benchmark/banks/walk.py --out benchmark/banks/walk-0.2.json

The policy is the actor of ``artifacts/walk_r5/policy_params`` (PPO on
the walking task; the repo's eval keeps it upright at a 0.2 m/s forward
command for whole 20 s episodes). ``--envs`` walking environments
(``benchmark/reference/walking.py``, the trainer's task: frame_skip 10,
partial observations over a window of 10, the fast plant at its 4 / 8
budget) start from the model's initial state, heading 0, under a fixed
forward command of ``--speed``, and take the policy's stochastic actions
drawn from ``--seed``. The state (qpos, qvel, act, sensordata) of every
environment is kept at each of the ``--keep`` steps; an environment
whose episode ended is dropped. The file holds the states, their layout
and a summary of the walk. It needs the CPU alone and takes some minutes.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

POLICY = os.path.join(ROOT, "artifacts", "walk_r5", "policy_params", "state.npz")


def actor(path: str, dtype):
    """The policy's actor from a JAX policy checkpoint's leaves: (bias,
    kernel) per layer, then the critic's, then the log standard
    deviation; a kernel is (in, out)."""
    import numpy as np
    import torch

    from benchmark.reference import env

    d = np.load(path)
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    return env.ActorWeights([t(d[f"leaf_{i}"].T) for i in (1, 3, 5, 7)],
                            [t(d[f"leaf_{i}"]) for i in (0, 2, 4, 6)],
                            t(d["leaf_16"]))


def walk(envs: int, keep, seed: int, speed: float, policy: str = POLICY) -> dict:
    import torch

    from benchmark.reference import commands, env, spec, walking

    f64 = torch.float64
    m = spec.get_fast_plant_model(n_directions=128, n_secondary=64)
    opts = commands.SampleOptions.from_dict({
        "fixed_speed": speed, "fixed_heading_angle": 0.0,
        "fixed_velocity_angle": 0.0})
    cfg = walking.WalkingConfig(
        max_time=20.0, frame_skip=10, obs_window=10, partial_obs=True,
        random_controls=True, random_init=False, reset_options=opts,
        solver_iterations=4, dtype=f64)
    w = actor(policy, f64)
    gen = torch.Generator().manual_seed(seed)
    st, obs = walking.reset(m, cfg, envs, gen)
    alive = torch.ones(envs, dtype=torch.bool)
    x0 = st.phys.qpos[:, 0].clone()
    states, t0 = [], time.perf_counter()
    for k in range(1, max(keep) + 1):
        (out,) = env.step(m, cfg, cfg, w, [env.StepInput(
            st, obs, seed * 100003 + k, seed * 100003 + 50000 + k)], 4, 8, f64)
        alive &= ~out.done
        st, obs = out.state, out.obs
        if k in keep:
            ph = st.phys
            for i in range(envs):
                if alive[i]:
                    states.append([float(v) for v in torch.cat(
                        [ph.qpos[i], ph.qvel[i], ph.act[i], ph.sensordata[i]])])
    ph = st.phys
    secs = max(keep) * cfg.control_dt(m)
    return {
        "layout": {"nq": m.nq, "nv": m.nv, "na": m.na,
                   "nsens": int(ph.sensordata.shape[1])},
        "made_by": "benchmark/banks/walk.py",
        "walk": {"envs": envs, "keep_steps": list(keep), "seed": seed,
                 "command_mps": speed, "control_dt_s": cfg.control_dt(m),
                 "survived": int(alive.sum()),
                 "mean_vx_mps": float(((ph.qpos[:, 0] - x0) / secs)[alive].mean()),
                 "base_height_m": [float(ph.qpos[alive, 2].min()),
                                   float(ph.qpos[alive, 2].max())],
                 "cpu_s": time.perf_counter() - t0},
        "states": states,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--envs", type=int, default=16)
    p.add_argument("--keep", default="100,150,200,250")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--speed", type=float, default=0.2)
    args = p.parse_args(argv)
    import torch

    torch.set_num_threads(2)
    res = walk(args.envs, [int(k) for k in args.keep.split(",")], args.seed,
               args.speed)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=0)
    print(json.dumps(res["walk"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
