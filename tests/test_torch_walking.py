"""The second slice as a whole: the batched walking task and the
auto-resetting vector env against the JAX package, float64 on the CPU.

Both sides get the same state (the JAX ``WalkingState`` converted by
``convert.walking_state``) and the same actions, made from numpy seeds.
The JAX side runs ``walking.batched_step`` / ``batched_autoreset_step``
with ``engine_impl="leg"`` eagerly (``jax.disable_jit``); its ``"pallas"``
engine differs only in the kernel behind ``control_step``, which
tests/test_torch_substep.py compares on its own. The port runs ``"leg"``
(the eager engine) and ``"pallas"`` (on the CPU, the substep kernel's plain
version). Reset options are deterministic (fixed command, no random yaw)
so that the two frameworks' different random streams do not matter.

Tolerances are those of tests/test_lane_task.py: obs rtol 1e-7 / atol
1e-9, reward and components 1e-7 / 1e-8, phys 1e-8 / 1e-10, ideal
position 1e-12, estimator 1e-9 / 1e-12; terminated exact."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.envs import vector_env as jvec
from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu.tasks import walking as jwalk
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.envs import vector_env as tvec
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.tasks import commands as tcommands
from quadruped_gym_tpu_torch.tasks import rewards as trewards
from quadruped_gym_tpu_torch.tasks import walking as twalk

N = 4
JM, TM = jspec.get_planning_model(), tspec.get_planning_model()
FIXED = dict(fixed_heading_angle=0.4, fixed_velocity_angle=-0.7,
             fixed_speed=0.3)


def _cfgs(partial, max_time=5.0, frame_skip=2):
    kw = dict(max_time=max_time, frame_skip=frame_skip, settling_time=0.004,
              random_controls=True, random_init=False,
              obs_window=3 if partial else 1, partial_obs=partial,
              solver_iterations=4)
    return (jwalk.WalkingConfig(
                reset_options=jcommands.SampleOptions(**FIXED),
                dtype=jnp.float64, **kw),
            twalk.WalkingConfig(
                reset_options=tcommands.SampleOptions(**FIXED),
                dtype=torch.float64, **kw))


def _jax_reset(jcfg, seed=0):
    keys = jax.random.split(jax.random.PRNGKey(seed), N)
    return jax.vmap(lambda k: jwalk.reset(JM, jcfg, k))(keys)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _perturb(state, seed, times):
    """A moving start, two envs in the air, each env at its own time."""
    rng = np.random.default_rng(seed)
    qpos = np.array(state.phys.qpos) + 0.02 * rng.standard_normal((N, JM.nq))
    qpos[:2, 2] += 0.5
    qvel = 0.1 * rng.standard_normal((N, JM.nv))
    phys = state.phys._replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                               time=jnp.asarray(times))
    return state._replace(phys=phys)


def _close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _assert_state(got, want):
    for f in ("qpos", "qvel", "act", "time"):
        _close(getattr(got.phys, f), getattr(want.phys, f), 1e-8, 1e-10, f)
    _close(got.phys.sensordata, want.phys.sensordata, 1e-7, 1e-9, "sens")
    _close(got.ideal_position, want.ideal_position, 1e-12, 0, "ideal")
    for f in got.est._fields:
        _close(getattr(got.est, f), getattr(want.est, f), 1e-9, 1e-12, f)
    for f in got.rew._fields:
        _close(getattr(got.rew, f), getattr(want.rew, f), 1e-7, 1e-8, f)
    for f in got.cmd._fields:
        _close(getattr(got.cmd, f), getattr(want.cmd, f), 1e-12, 1e-14, f)
    _close(got.obs.mad_quat, want.obs.mad_quat, 1e-7, 1e-9, "mad_quat")
    _close(got.obs.buffer, want.obs.buffer, 1e-7, 1e-9, "buffer")
    _close(got.applied_ctrl, want.applied_ctrl, 1e-14, 0, "applied_ctrl")


def _assert_step(got, want):
    _close(got.obs, want.obs, 1e-7, 1e-9, "obs")
    _close(got.reward, want.reward, 1e-7, 1e-8, "reward")
    _close(got.reward_components, want.reward_components, 1e-7, 1e-8,
           "components")
    _assert_state(got.state, want.state)


@pytest.mark.parametrize("partial", [False, True])
def test_reset_matches_jax(partial):
    jcfg, tcfg = _cfgs(partial)
    jstate, jobs = _jax_reset(jcfg)
    tstate, tobs = twalk.reset(TM, tcfg, N, _gen())
    assert tobs.shape == (N, twalk.obs_size(tcfg, TM)) \
        == (N, jwalk.obs_size(jcfg, JM))
    assert tobs.dtype == torch.float64
    _close(tobs, jobs, 1e-12, 1e-14)
    _assert_state(tstate, jstate)
    via = convert.walking_state(jstate, device="cpu")
    _assert_state(via, jstate)
    assert via.est.buffer_index.dtype == torch.int64
    assert via.rew.ctrl_cost_ref_set.dtype == torch.bool
    assert not hasattr(via, "key")


def test_reset_randomizes_yaw_and_commands():
    cfg = twalk.WalkingConfig(random_controls=True, random_init=True,
                              dtype=torch.float64)
    st, _ = twalk.reset(TM, cfg, 256, _gen(1))
    quat = st.phys.qpos[:, 3:7]
    torch.testing.assert_close(torch.linalg.vector_norm(quat, dim=1),
                               torch.ones(256, dtype=torch.float64))
    assert float(quat[:, 1:3].abs().max()) == 0.0  # yaw only
    yaw = 2 * torch.atan2(quat[:, 3], quat[:, 0])
    assert float(yaw.min()) >= 0.0 and float(yaw.max()) <= 2 * np.pi
    assert float(yaw.std()) > 1.0
    speed, _ = tcommands.velocity_speed_alpha(st.cmd)
    assert 0.0 <= float(speed.min()) and float(speed.max()) <= 1.0
    assert float(speed.std()) > 0.1
    still, _ = twalk.reset(TM, twalk.WalkingConfig(dtype=torch.float64), 2,
                           _gen())
    assert float(still.cmd.velocity.abs().max()) == 0.0
    # the oracle-engine step takes the same batch of environments
    out = twalk.step(TM, dataclasses.replace(cfg, solver_iterations=2,
                                             max_contacts=4, frame_skip=1),
                     st, torch.zeros((256, 12), dtype=torch.float64))
    assert out.obs.shape == (256, 33) and out.reward.shape == (256,)
    assert bool(torch.isfinite(out.obs).all())


@pytest.mark.parametrize("partial,impl,frame_skip", [
    (False, "leg", 2), (True, "pallas", 1)])
def test_batched_steps_match_jax(partial, impl, frame_skip):
    """Two control steps: the first under the settling mask, the second
    under the given actions; env 3 runs past ``max_time`` on the first."""
    jcfg, tcfg = _cfgs(partial, max_time=0.5, frame_skip=frame_skip)
    jstate, _ = _jax_reset(jcfg)
    jstate = _perturb(jstate, 3, [0.0, 0.0, 0.002, 0.499])
    tstate = convert.walking_state(jstate, device="cpu")
    rng = np.random.default_rng(4)
    terminated = []
    for k in range(2):
        action = 0.4 * rng.standard_normal((N, 12))
        action[0] = 3.0  # outside ctrlrange: clipped
        with jax.disable_jit():
            want = jwalk.batched_step(JM, jcfg, jstate, jnp.asarray(action),
                                      engine_impl="leg")
        got = twalk.batched_step(TM, tcfg, tstate, torch.as_tensor(action),
                                 engine_impl=impl)
        _assert_step(got, want)
        np.testing.assert_array_equal(got.terminated.numpy(),
                                      np.asarray(want.terminated))
        assert got.terminated.dtype == torch.bool
        terminated.append(got.terminated.numpy().copy())
        jstate, tstate = want.state, got.state
    np.testing.assert_array_equal(terminated[0], [False, False, False, True])
    assert float(tstate.applied_ctrl[0].max()) <= 1.0
    assert got.obs.shape == (N, twalk.obs_size(tcfg, TM))


def test_batched_step_engines_agree_and_refuse():
    _, tcfg = _cfgs(True)
    st, _ = twalk.reset(TM, tcfg, N, _gen())
    action = torch.as_tensor(
        0.3 * np.random.default_rng(0).standard_normal((N, 12)))
    outs = [twalk.batched_step(TM, tcfg, st, action, engine_impl=impl)
            for impl in ("auto", "leg", "pallas")]
    for other in outs[1:]:
        torch.testing.assert_close(other.obs, outs[0].obs, rtol=0, atol=0)
        torch.testing.assert_close(other.reward, outs[0].reward, rtol=0,
                                   atol=0)
    with pytest.raises(NotImplementedError, match="A.10"):
        twalk.batched_step(TM, tcfg, st, action, engine_impl="lane")
    with pytest.raises(ValueError, match="unknown engine_impl"):
        twalk.batched_step(TM, tcfg, st, action, engine_impl="xla")


def test_batched_autoreset_step_matches_jax():
    """Forced terminations (envs 1 and 3 run out of time): those lanes
    come back fresh, the estimator and the frozen control-cost reference
    survive, and all of it equals the JAX package's step."""
    jcfg, tcfg = _cfgs(True, max_time=0.5, frame_skip=1)
    jstate, _ = _jax_reset(jcfg)
    jstate = _perturb(jstate, 5, [0.1, 0.499, 0.2, 0.4995])
    tstate = convert.walking_state(jstate, device="cpu")
    gen = _gen(7)
    rng = np.random.default_rng(6)
    for k in range(2):
        action = 0.4 * rng.standard_normal((N, 12))
        with jax.disable_jit():
            want = jvec.batched_autoreset_step(JM, jcfg, jstate,
                                               jnp.asarray(action),
                                               engine_impl="leg")
        got = tvec.batched_autoreset_step(TM, tcfg, tstate,
                                          torch.as_tensor(action), gen,
                                          engine_impl="pallas")
        _assert_step(got, want)
        np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
        if k == 0:
            first = got
        jstate, tstate = want.state, got.state
    done = first.done.numpy()
    np.testing.assert_array_equal(done, [False, True, False, True])
    st = first.state
    fresh, fresh_obs = twalk.reset(TM, tcfg, N, _gen())
    # reset lanes are fresh ...
    assert np.all(st.phys.time.numpy()[done] == 0.0)
    torch.testing.assert_close(st.phys.qpos[done], fresh.phys.qpos[done])
    assert float(st.phys.qvel[done].abs().max()) == 0.0
    torch.testing.assert_close(first.obs[done], fresh_obs[done])
    assert not bool(st.rew.has_prev_derive[done].any())
    torch.testing.assert_close(st.rew.previous_ctrl[done],
                               fresh.rew.previous_ctrl[done])
    assert float(st.ideal_position[done].abs().max()) == 0.0
    # ... the others went on ...
    assert np.all(st.phys.time.numpy()[~done] > 0.1)
    assert bool(st.rew.has_prev_derive[~done].all())
    # ... and the persistent carries survive on every lane
    assert bool(st.rew.ctrl_cost_ref_set.all())
    assert float(st.rew.ctrl_cost_ref.min()) > 0.0
    assert bool(st.est.has_prev_sample.all())
    assert np.all(st.est.sample_count.numpy() == 1)
    # the reward and done of a reset lane describe the step that ended it
    assert bool(torch.isfinite(first.reward).all())


@functools.lru_cache(maxsize=None)
def _jax_autoreset_fn(partial, max_time):
    jcfg, _ = _oracle_cfgs(partial, max_time)
    return jax.jit(jax.vmap(
        lambda st, a: jvec.autoreset_step(JM, jcfg, st, a)))


def _oracle_cfgs(partial, max_time):
    jcfg, tcfg = _cfgs(partial, max_time=max_time, frame_skip=2)
    kw = dict(max_contacts=8, solver_iterations=3)
    return (dataclasses.replace(jcfg, **kw), dataclasses.replace(tcfg, **kw))


def test_oracle_step_and_autoreset_match_jax(partial=True):
    """Three control steps of ``walking.step`` and ``autoreset_step`` on
    the oracle engine against the JAX package's (jitted, vmapped over the
    envs): env 3 runs out of time on the first step and comes back fresh,
    env 1 on the second. ``walking.step`` is what ``autoreset_step``
    reports for the step itself, and its state where no reset happened.

    A lane that was reset starts at rest in the air and falls straight
    down, where the progress-direction term v/|v| amplifies rounding
    (physics agree to 1e-14 there, the term to 1e-6): from then on that
    one component, and the total it goes into, are held to 1e-5 instead."""
    jcfg, tcfg = _oracle_cfgs(partial, 0.5)
    assert tcfg.max_contacts == 8
    assert twalk.WalkingConfig().max_contacts == \
        jwalk.WalkingConfig().max_contacts == 24
    jstate, _ = _jax_reset(jcfg)
    jstate = _perturb(jstate, 8, [0.0, 0.495, 0.002, 0.499])
    tstate = convert.walking_state(jstate, device="cpu")
    gen = _gen(9)
    rng = np.random.default_rng(10)
    dones = []
    direction = trewards.REWARD_KEYS.index("progress_direction_reward_local")
    others = [i for i in range(11) if i != direction]
    fresh = np.zeros(N, dtype=bool)
    for k in range(3):
        action = 0.4 * rng.standard_normal((N, 12))
        action[2] = -3.0  # outside ctrlrange: clipped
        want = _jax_autoreset_fn(partial, 0.5)(jstate, jnp.asarray(action))
        plain = twalk.step(TM, tcfg, tstate, torch.as_tensor(action))
        got = tvec.autoreset_step(TM, tcfg, tstate, torch.as_tensor(action),
                                  gen)
        done = np.asarray(want.done)
        np.testing.assert_array_equal(got.done.numpy(), done)
        np.testing.assert_array_equal(plain.terminated.numpy(), done)
        _close(got.obs, want.obs, 1e-7, 1e-9, "obs")
        _assert_state(got.state, want.state)
        for out in (got, plain):
            rew, comp = out.reward.numpy(), out.reward_components.numpy()
            wrew = np.asarray(want.reward)
            wcomp = np.asarray(want.reward_components)
            _close(rew[~fresh], wrew[~fresh], 1e-7, 1e-8, "reward")
            _close(comp[~fresh], wcomp[~fresh], 1e-7, 1e-8, "components")
            _close(comp[fresh][:, others], wcomp[fresh][:, others], 1e-7,
                   1e-8, "components of reset lanes")
            _close(comp[fresh], wcomp[fresh], 1e-5, 1e-5, "direction")
            _close(rew[fresh], wrew[fresh], 1e-5, 1e-5, "reward, reset lanes")
        _close(plain.obs[~done], np.asarray(want.obs)[~done], 1e-7, 1e-9)
        _close(plain.state.phys.qvel[~done],
               np.asarray(want.state.phys.qvel)[~done], 1e-8, 1e-10)
        # the step advanced time on the lanes that ended, the reset zeroed it
        assert np.all(plain.state.phys.time.numpy()[done] >= 0.5)
        assert np.all(got.state.phys.time.numpy()[done] == 0.0)
        dones.append(done.copy())
        fresh = fresh | done
        jstate, tstate = want.state, got.state
    np.testing.assert_array_equal(dones[0], [False, False, False, True])
    np.testing.assert_array_equal(dones[1], [False, True, False, False])
    assert not dones[2].any()
    assert float(tstate.applied_ctrl[2].min()) >= -1.0


def test_vector_walking_env():
    _, tcfg = _cfgs(True)
    env = tvec.VectorWalkingEnv(TM, tcfg, N, lane_physics=True, seed=3,
                                device="cpu")
    assert env.obs_size == 3 * 26 and env.num_envs == N
    state, obs = env.reset()
    assert obs.shape == (N, env.obs_size)
    out = env.step(state, torch.zeros((N, 12), dtype=torch.float64))
    assert isinstance(out, tvec.VectorStepOutput)
    assert out.obs.shape == (N, env.obs_size) and out.done.dtype == torch.bool
    assert out.reward_components.shape == (N, 11)
    assert all(bool(torch.isfinite(x).all())
               for x in (out.obs, out.reward, out.reward_components))
    # the default is the oracle engine, as in the JAX package
    import inspect
    for cls in (tvec.VectorWalkingEnv, jvec.VectorWalkingEnv):
        assert inspect.signature(cls).parameters[
            "lane_physics"].default is False
    oracle = tvec.VectorWalkingEnv(TM, tcfg, N, seed=3, device="cpu")
    assert oracle.lane_physics is False
    state2, obs2 = oracle.reset()
    torch.testing.assert_close(obs2, obs, rtol=0, atol=0)
    out2 = oracle.step(state2, torch.zeros((N, 12), dtype=torch.float64))
    assert out2.obs.shape == out.obs.shape and out2.done.dtype == torch.bool
    # the same step on another engine: the same up to the solvers' budgets
    torch.testing.assert_close(out2.state.phys.qpos, out.state.phys.qpos,
                               rtol=0, atol=1e-4)
    torch.testing.assert_close(out2.reward, out.reward, rtol=0, atol=1e-2)
    if not torch.cuda.is_available():  # the card unless the caller says cpu
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tvec.VectorWalkingEnv(TM, tcfg, N)
