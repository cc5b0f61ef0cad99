"""The walking task and the vector env through the port's lane engine on
a model that is not leg-compatible (``torch_models.incompatible_full``:
the ``full`` collision model, 25 geoms, base and hips included, with one
shin heavier than the others), float64 on the CPU.

``walking.batched_step`` keeps the task layer and routes the physics
substeps through the lane engine; from airborne, moving start states it
must equal ``walking.step`` on the oracle engine, as
tests/test_lane_task.py holds the JAX package's: obs rtol 1e-7 / atol
1e-9, reward and components 1e-7 / 1e-8, phys 1e-8 / 1e-10, terminated
exact. (Smooth flight is where the two engines agree exactly; the
lane engine's contact physics is held to the JAX package's in
tests/test_torch_lane_engine.py.)"""

import dataclasses

import numpy as np
import pytest
import torch

from quadruped_gym_tpu_torch.envs import vector_env
from quadruped_gym_tpu_torch.tasks import walking
from torch_models import incompatible_full

N = 4
M = incompatible_full()
CFG = walking.WalkingConfig(
    max_time=5.0, frame_skip=2, settling_time=0.004, random_controls=True,
    random_init=True, solver_iterations=8, dtype=torch.float64)


def _reset(seed=0, cfg=CFG, n=N):
    return walking.reset(M, cfg, n, torch.Generator().manual_seed(seed))


def _airborne(state, seed):
    rng = np.random.default_rng(seed)
    qpos = state.phys.qpos.clone()
    qpos[:, 2] += 0.5
    qpos += torch.as_tensor(0.02 * rng.standard_normal(qpos.shape))
    qvel = state.phys.qvel + torch.as_tensor(
        0.1 * rng.standard_normal(state.phys.qvel.shape))
    return state._replace(phys=state.phys._replace(qpos=qpos, qvel=qvel))


def test_batched_step_matches_oracle_step():
    state, _ = _reset()
    state = _airborne(state, 1)
    action = torch.as_tensor(
        0.3 * np.random.default_rng(2).standard_normal((N, M.nu)))
    want = walking.step(M, CFG, state, action)
    got = walking.batched_step(M, CFG, state, action, newton_iterations=8,
                               ls_iterations=12)
    torch.testing.assert_close(got.obs, want.obs, rtol=1e-7, atol=1e-9)
    torch.testing.assert_close(got.reward, want.reward, rtol=1e-7,
                               atol=1e-8)
    torch.testing.assert_close(got.reward_components,
                               want.reward_components, rtol=1e-7, atol=1e-8)
    assert torch.equal(got.terminated, want.terminated)
    for f in ("qpos", "qvel", "act", "time"):
        torch.testing.assert_close(getattr(got.state.phys, f),
                                   getattr(want.state.phys, f),
                                   rtol=1e-8, atol=1e-10, msg=f)


def test_engine_choice_on_full():
    """``"auto"`` picks the lane engine for a model that is not
    leg-compatible (``full`` with uneven legs), ``"pallas"`` warns and
    falls back to it."""
    state, _ = _reset(3)
    action = torch.as_tensor(
        0.3 * np.random.default_rng(4).standard_normal((N, M.nu)))
    kw = dict(newton_iterations=2, ls_iterations=4)
    lane = walking.batched_step(M, CFG, state, action, engine_impl="lane",
                                **kw)
    auto = walking.batched_step(M, CFG, state, action, engine_impl="auto",
                                **kw)
    with pytest.warns(UserWarning, match="falling back to the slower lane"):
        pallas = walking.batched_step(M, CFG, state, action,
                                      engine_impl="pallas", **kw)
    for out in (auto, pallas):
        assert torch.equal(out.obs, lane.obs)
        assert torch.equal(out.state.phys.qpos, lane.state.phys.qpos)


def test_vector_env_lane_physics_on_full():
    """``VectorWalkingEnv(lane_physics=True)`` on ``full`` with uneven legs
    resets and steps on the lane engine, and an env that runs out of time
    comes back fresh."""
    cfg = dataclasses.replace(CFG, max_time=0.01, solver_iterations=2)
    env = vector_env.VectorWalkingEnv(M, cfg, 3, lane_physics=True, seed=5,
                                      device="cpu")
    state, obs = env.reset()
    assert obs.shape == (3, env.obs_size)
    rng = np.random.default_rng(6)
    dones = []
    for _ in range(3):
        out = env.step(state, torch.as_tensor(
            0.2 * rng.standard_normal((3, M.nu))))
        state = out.state
        dones.append(out.done.clone())
        assert torch.isfinite(out.obs).all()
        assert torch.isfinite(out.reward).all()
        assert torch.isfinite(state.phys.qpos).all()
    assert torch.stack(dones).any()
