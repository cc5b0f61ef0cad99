"""The policy eval (``rl/evaluate.py``) against the JAX package's, on the CPU.

The committed walk_r5 policy plays 30 control steps (0.6 s) through the
JAX ``eval_rollout``, as tests/test_walk_policy.py plays it, with the
env's steps recorded. Its actions replayed through the port's env give
the JAX observations (float64); the port's float32 actor on the JAX
observations gives the JAX actions (float32 on both sides); and the
port's own ``eval_rollout`` walks as well. The closed loop is not held
to the bit: the float32 actor rounds differently in XLA and torch
(~1e-7 an action), and 30 steps of contact dynamics grow that (to
7e-7 of a metric, 4e-5 of a step reward of ~27), so the metrics and
rewards are held to JAX's at a relative 1e-4."""

import os

import jax
import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files, no_cache_writes  # noqa: F401

from quadruped_gym_tpu.rl import evaluate as jevaluate
from quadruped_gym_tpu.rl import networks as jnet
from quadruped_gym_tpu.runtime import checkpoint as jcheckpoint
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.envs import gym_env
from quadruped_gym_tpu_torch.models import spec
from quadruped_gym_tpu_torch.rl import evaluate, networks, ppo
from quadruped_gym_tpu_torch.runtime import checkpoint
from quadruped_gym_tpu_torch.tasks import walking

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POLICY = os.path.join(REPO, "artifacts", "walk_r5", "policy_params")
WINDOW, MAX_TIME, FRAME_SKIP, STEPS = 10, 0.6, 10, 30
F64 = torch.float64
OBS_TOL = 1e-7  # float64; the Madgwick angles of the first free fall
ACTOR_TOL = 1e-5  # float32 on both sides, actions of magnitude ~1
METRIC_RTOL = 1e-4


@pytest.fixture(scope="module")
def jax_run():
    """JAX's eval of walk_r5, each env step's action and observation
    recorded."""
    with no_cache_writes():
        return _jax_run()


def _jax_run():
    example = jnet.init(jax.random.PRNGKey(0),
                        jnet.NetConfig(obs_dim=26 * WINDOW, act_dim=12),
                        dtype=np.float32)
    params, _ = jcheckpoint.restore(POLICY, example)
    record = {"obs": [], "actions": [], "rewards": []}
    base = jevaluate.POWalkingQuadrupedEnv

    class Recording(base):
        def reset(self, *a, **kw):
            obs, info = super().reset(*a, **kw)
            record["obs"].append(np.asarray(obs))
            return obs, info

        def step(self, action):
            record["actions"].append(np.asarray(action))
            obs, r, term, trunc, info = super().step(action)
            record["obs"].append(np.asarray(obs))
            record["rewards"].append(r)
            return obs, r, term, trunc, info

    jevaluate.POWalkingQuadrupedEnv = Recording
    try:
        metrics = jevaluate.eval_rollout(
            params, obs_window=WINDOW, max_time=MAX_TIME,
            frame_skip=FRAME_SKIP, deterministic=True, seed=0)
    finally:
        jevaluate.POWalkingQuadrupedEnv = base
    return metrics, record


@pytest.fixture(scope="module")
def net32():
    arrays, step = checkpoint.read(POLICY)
    assert step >= 20
    return convert.policy_params(arrays, torch.float32, "cpu")


def test_replay_of_jax_actions_matches_jax(jax_run):
    metrics, rec = jax_run
    assert metrics["steps"] == STEPS == len(rec["actions"])
    env = gym_env.POWalkingQuadrupedEnv(
        obs_window=WINDOW, max_time=MAX_TIME, frame_skip=FRAME_SKIP,
        dtype=F64, device="cpu")
    env.control_inputs.set_orientation(0.0)
    env.control_inputs.set_velocity_speed_alpha(0.2, 0.0)
    obs, _ = env.reset()
    np.testing.assert_array_equal(obs, rec["obs"][0])
    done = False
    for i, a in enumerate(rec["actions"]):
        assert not done
        obs, r, term, trunc, _ = env.step(a)
        np.testing.assert_allclose(obs, rec["obs"][i + 1], rtol=0,
                                   atol=OBS_TOL, err_msg=f"step {i}")
        assert abs(r - rec["rewards"][i]) <= 1e-8 * max(1.0, abs(r))
        done = term or trunc
    assert done  # the time limit ends the episode at step 30, as in JAX


def test_actor_matches_jax_in_float32(jax_run, net32):
    _, rec = jax_run
    obs = np.stack(rec["obs"][:-1]).astype(np.float32)
    with torch.no_grad():
        got = networks.actor_mean(net32, torch.as_tensor(obs)).numpy()
    want = np.stack(rec["actions"])  # JAX clips to [-1, 1] before stepping
    np.testing.assert_allclose(np.clip(got, -1.0, 1.0), want, rtol=0,
                               atol=ACTOR_TOL)
    assert got.dtype == np.float32


def test_eval_rollout_walks_like_jax(jax_run, net32):
    want, _ = jax_run
    got = evaluate.eval_rollout(net32, obs_window=WINDOW, max_time=MAX_TIME,
                                frame_skip=FRAME_SKIP, deterministic=True,
                                seed=0, device="cpu", dtype=F64)
    assert set(got) == set(want)
    assert got["steps"] == STEPS and got["survived"] == want["survived"]
    assert got["mean_uprightness"] > 0.9
    assert got["mean_tracking_error"] < 0.5
    for k in ("episode_return", "mean_tracking_error",
              "final_tracking_error", "mean_uprightness"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["rewards"], want["rewards"],
                               rtol=METRIC_RTOL, atol=1e-6)
    assert got["command_speed"] == want["command_speed"] == 0.2


def test_stochastic_eval_is_seeded(net32):
    kw = dict(obs_window=WINDOW, max_time=0.06, frame_skip=FRAME_SKIP,
              deterministic=False, device="cpu", dtype=F64)
    a = evaluate.eval_rollout(net32, seed=3, **kw)
    b = evaluate.eval_rollout(net32, seed=3, **kw)
    c = evaluate.eval_rollout(net32, seed=4, **kw)
    assert a["rewards"] == b["rewards"] and a["steps"] == 3
    assert a["rewards"] != c["rewards"]


def test_load_policy_reads_both_packages_checkpoints(tmp_path, net32):
    env_cfg = walking.WalkingConfig(partial_obs=True, obs_window=WINDOW)
    obs_dim = walking.obs_size(env_cfg, spec.get_mpc_plant_model())
    jax_net = evaluate.load_policy(POLICY, obs_dim, device="cpu")
    for a, b in zip(jax_net.state_dict().values(),
                    net32.state_dict().values()):
        assert torch.equal(a, b)
    # a train state of this package's trainer, its network at the default
    # widths
    ts = ppo.init_train_state(spec.get_mpc_plant_model(), env_cfg,
                              ppo.PPOConfig(num_envs=2, num_steps=1), 7,
                              device="cpu")
    checkpoint.save(str(tmp_path / "policy"), ts, step=1)
    got = evaluate.load_policy(str(tmp_path / "policy"), obs_dim,
                               device="cpu")
    for a, b in zip(got.state_dict().values(), ts.net.state_dict().values()):
        assert torch.equal(a, b)


def test_main_plays_and_plots(tmp_path, capsys, monkeypatch):
    """``main`` restores the policy, plays its episode (cut here from 20 s
    to 0.09 s: 5 control steps) and plots the rewards."""
    real = evaluate.evaluate_model
    monkeypatch.setattr(evaluate, "evaluate_model", lambda policy, **kw: real(
        policy, **dict(kw, max_time=0.09)))
    png = str(tmp_path / "plots" / "eval_rewards.png")
    hist = evaluate.main(["--policy", POLICY, "--plot", png], device="cpu")
    assert len(hist) == 5 and all(np.isfinite(hist))
    printed = capsys.readouterr().out
    assert "over 5 steps" in printed and f"wrote {png}" in printed
    assert os.path.getsize(png) > 0
