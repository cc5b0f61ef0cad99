"""PPO and its networks against the JAX package, float64 on the CPU.

Both sides get the same parameters (the JAX tree carried across by
``convert.policy_params`` / ``convert.train_state``) and the same inputs,
made from numpy seeds. The two frameworks draw different numbers from a
seed, so where the port draws (action noise, epoch permutations) it is
handed what JAX drew (``torch.randn`` / ``torch.randperm`` replaced for
the call, as tests/test_torch_closed_loop.py does).

Tolerances: networks and GAE 1e-12; the loss and its gradients 1e-10;
three clipped Adam steps 1e-10; one whole update (rollout on the oracle
engine, GAE, 2 epochs of 2 minibatches) 1e-8 on parameters, Adam moments
and metrics. The whole update starts from a MOVING state: from rest the
progress-direction reward v/|v| amplifies rounding (ROADMAP.md §C)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_jax_cache import no_cache_files  # noqa: F401 (autouse fixture)

from quadruped_gym_tpu.models import spec as jspec
from quadruped_gym_tpu.rl import networks as jnet
from quadruped_gym_tpu.rl import ppo as jppo
from quadruped_gym_tpu.runtime import checkpoint as jcheckpoint
from quadruped_gym_tpu.tasks import commands as jcommands
from quadruped_gym_tpu.tasks import walking as jwalk
from quadruped_gym_tpu_torch import convert
from quadruped_gym_tpu_torch.models import spec as tspec
from quadruped_gym_tpu_torch.rl import networks as tnet
from quadruped_gym_tpu_torch.rl import ppo as tppo
from quadruped_gym_tpu_torch.tasks import commands as tcommands
from quadruped_gym_tpu_torch.tasks import walking as twalk

F64 = torch.float64
POLICY = "artifacts/walk_r5/policy_params"


def _close(got, want, rtol, atol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _random_params(seed, obs_dim, act_dim, hidden):
    """A JAX params tree in float64 with every leaf perturbed (biases and
    log_std not zero)."""
    p = jnet.init(jax.random.PRNGKey(seed),
                  jnet.NetConfig(obs_dim, act_dim, hidden), jnp.float64)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape)), p)


def _jax_grads_like(net, tree):
    """``net``'s ``.grad`` in the layout of a JAX params tree."""
    return [(t.grad, a) for t, a in convert._policy_pairs(net, tree)]


# --------------------------------------------------------------------------
# networks


@functools.lru_cache(maxsize=None)
def _committed_policy():
    example = jnet.init(jax.random.PRNGKey(0), jnet.NetConfig(260, 12))
    params, step = jcheckpoint.restore(POLICY, example)
    return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params), step


def test_committed_policy_matches_jax():
    jparams, step = _committed_policy()
    assert step == 28
    net = convert.policy_params(np.load(f"{POLICY}/state.npz"),
                                device="cpu")
    assert net.cfg == tnet.NetConfig(260, 12, (256, 256, 128))
    assert net.log_std.dtype == F64
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((64, 260))
    action = rng.standard_normal((64, 12))
    t_obs = torch.as_tensor(obs)
    with torch.no_grad():
        mean = tnet.actor_mean(net, t_obs)
        _close(mean, jnet.actor_mean(jparams, obs), 1e-12, 1e-12, "mean")
        _close(tnet.value(net, t_obs), jnet.value(jparams, obs), 1e-12,
               1e-12, "value")
        _close(tnet.gaussian_log_prob(mean, net.log_std,
                                      torch.as_tensor(action)),
               jnet.gaussian_log_prob(jnet.actor_mean(jparams, obs),
                                      jparams["log_std"], action),
               1e-12, 1e-12, "log_prob")
        _close(tnet.entropy(net.log_std), jnet.entropy(jparams["log_std"]),
               1e-12, 1e-12, "entropy")
    # the nested dict converts to the same network
    again = convert.policy_params(jparams, device="cpu")
    for a, b in zip(net.state_dict().values(), again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_sample_action_draws_from_the_generator():
    net = tnet.init(torch.Generator().manual_seed(0),
                    tnet.NetConfig(6, 4, (8,), init_log_std=-0.5),
                    dtype=F64)
    obs = torch.as_tensor(np.random.default_rng(1).standard_normal((3, 6)))
    a1, lp1 = tnet.sample_action(net, obs, torch.Generator().manual_seed(5))
    a2, lp2 = tnet.sample_action(net, obs, torch.Generator().manual_seed(5))
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)
    eps = torch.randn((3, 4), generator=torch.Generator().manual_seed(5),
                      dtype=F64)
    mean = tnet.actor_mean(net, obs)
    torch.testing.assert_close(a1, mean + np.exp(-0.5) * eps)
    torch.testing.assert_close(lp1, tnet.gaussian_log_prob(
        mean, net.log_std, a1))


@pytest.mark.parametrize("hidden", [(256, 256, 128), (16, 40)])
def test_init_is_orthogonal_with_the_jax_scales(hidden):
    cfg = tnet.NetConfig(30, 12, hidden, init_log_std=0.25)
    net = tnet.init(torch.Generator().manual_seed(3), cfg)
    assert net.log_std.dtype == torch.float32
    for name, out_scale in (("actor", 0.01), ("critic", 1.0)):
        lins = net.linears(name)
        assert len(lins) == len(hidden) + 1
        for i, lin in enumerate(lins):
            w = lin.weight.detach().double().T  # the JAX (in, out) layout
            scale = out_scale if i == len(lins) - 1 else np.sqrt(2.0)
            gram = w.T @ w if w.shape[0] >= w.shape[1] else w @ w.T
            torch.testing.assert_close(
                gram / scale**2, torch.eye(gram.shape[0], dtype=F64),
                rtol=0, atol=1e-5)
            assert float(lin.bias.detach().abs().max()) == 0.0
    assert float((net.log_std.detach() - 0.25).abs().max()) == 0.0
    same = tnet.init(torch.Generator().manual_seed(3), cfg)
    other = tnet.init(torch.Generator().manual_seed(4), cfg)
    for a, b, c in zip(net.parameters(), same.parameters(),
                       other.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        if a.dim() == 2:
            assert not torch.equal(a, c)


# --------------------------------------------------------------------------
# GAE, loss, optimizer


def test_gae_with_dones_matches_jax():
    T, N = 6, 5
    rng = np.random.default_rng(2)
    done = rng.uniform(size=(T, N)) < 0.25
    done[2, 1] = done[5, 3] = True
    fields = dict(obs=np.zeros((T, N, 1)), action=np.zeros((T, N, 1)),
                  log_prob=np.zeros((T, N)), value=rng.standard_normal((T, N)),
                  reward=rng.standard_normal((T, N)), done=done,
                  reward_components=np.zeros((T, N, 11)))
    last = rng.standard_normal(N)
    cfg = dict(gamma=0.97, gae_lambda=0.9)
    want = jppo._gae(jppo.PPOConfig(**cfg), jppo._Transition(
        **{k: jnp.asarray(v) for k, v in fields.items()}), jnp.asarray(last))
    got = tppo._gae(tppo.PPOConfig(**cfg), tppo._Transition(
        **{k: torch.as_tensor(v) for k, v in fields.items()}),
        torch.as_tensor(last))
    for g, w, name in zip(got, want, ("advantages", "returns")):
        _close(g, w, 1e-12, 1e-12, name)
    assert done.any() and not done.all()


def _loss_batch(params, seed, n=48):
    """A minibatch whose ratios spread past the clip range both ways."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((n, 10))
    action = rng.standard_normal((n, 12))
    logp = np.asarray(jnet.gaussian_log_prob(
        jnet.actor_mean(params, obs), params["log_std"], action))
    old_logp = logp + 0.4 * rng.standard_normal(n)
    return (obs, action, old_logp, rng.standard_normal(n),
            rng.standard_normal(n), rng.standard_normal(n))


@pytest.mark.parametrize("ent_coef", [0.0, 0.01])
def test_loss_and_gradients_match_jax(ent_coef):
    jparams = _random_params(5, 10, 12, (16, 16))
    batch = _loss_batch(jparams, 6)
    kw = dict(ent_coef=ent_coef, clip_eps=0.2, vf_coef=0.5)
    (jloss, jaux), jgrads = jax.value_and_grad(jppo._loss_fn, has_aux=True)(
        jparams, jppo.PPOConfig(**kw), tuple(map(jnp.asarray, batch)))
    ratio = np.exp(np.asarray(jnet.gaussian_log_prob(
        jnet.actor_mean(jparams, batch[0]), jparams["log_std"], batch[1]))
        - batch[2])
    assert (ratio > 1.2).any() and (ratio < 0.8).any()
    net = convert.policy_params(jparams, device="cpu")
    loss, aux = tppo._loss_fn(net, tppo.PPOConfig(**kw),
                              tuple(map(torch.as_tensor, batch)))
    loss.backward()
    _close(loss, jloss, 1e-10, 1e-12, "loss")
    for g, w, name in zip(aux, jaux, ("pg", "vf", "entropy", "kl")):
        _close(g, w, 1e-10, 1e-12, name)
    for g, w in _jax_grads_like(net, jgrads):
        _close(g, w, 1e-10, 1e-12, "gradient")


@pytest.mark.parametrize("max_norm", [0.5, 1e6], ids=["clipped", "unclipped"])
def test_adam_steps_match_optax(max_norm):
    """Three steps of ``clip_by_global_norm_`` + Adam against optax's
    chain (the ``jppo._optimizer`` of the JAX package) on the same
    gradients, with the clip active (gradient norms ~10 > 0.5) and not."""
    cfg = tppo.PPOConfig(max_grad_norm=max_norm, learning_rate=3e-3)
    jcfg = jppo.PPOConfig(max_grad_norm=max_norm, learning_rate=3e-3)
    jparams = _random_params(7, 10, 12, (16, 16))
    opt = jppo._optimizer(jcfg)
    jstate = opt.init(jparams)
    net = convert.policy_params(jparams, device="cpu")
    topt = tppo.make_optimizer(cfg, net)
    params = list(net.parameters())
    rng = np.random.default_rng(8)
    for _ in range(3):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape)), jparams)
        assert float(optax.global_norm(grads)) > 5.0
        updates, jstate = opt.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for t, a in convert._policy_pairs(net, grads):
            t.grad = torch.as_tensor(np.array(a))
        tppo.clip_by_global_norm_(params, cfg.max_grad_norm)
        topt.step()
    adam = convert._adam_state(jstate)
    for (t, w), (_, mu), (_, nu) in zip(
            convert._policy_pairs(net, jparams),
            convert._policy_pairs(net, adam.mu),
            convert._policy_pairs(net, adam.nu)):
        _close(t, w, 1e-10, 1e-12, "params")
        _close(topt.state[t]["exp_avg"], mu, 1e-10, 1e-14, "exp_avg")
        _close(topt.state[t]["exp_avg_sq"], nu, 1e-10, 1e-14, "exp_avg_sq")
        assert float(topt.state[t]["step"]) == int(adam.count) == 3


@pytest.mark.parametrize("bounds", [(-0.05, None), (None, 0.05)],
                         ids=["min", "max"])
def test_log_std_clamp_with_one_bound(bounds):
    lo, hi = bounds
    jparams = _random_params(9, 4, 12, (8,))
    net = convert.policy_params(jparams, device="cpu")
    tppo.clamp_log_std_(net, tppo.PPOConfig(log_std_min=lo, log_std_max=hi))
    want = jnp.clip(jparams["log_std"], lo, hi)
    _close(net.log_std, want, 0, 0)
    assert not np.array_equal(np.asarray(want),
                              np.asarray(jparams["log_std"]))
    before = net.log_std.detach().clone()
    tppo.clamp_log_std_(net, tppo.PPOConfig())
    torch.testing.assert_close(net.log_std.detach(), before, rtol=0, atol=0)


# --------------------------------------------------------------------------
# one whole update, and the lane-physics rollout

N, T = 4, 4
HIDDEN = (16, 16)
JM, TM = jspec.get_model(
    collision_geom_prefixes=jspec.MPC_COLLISION_PREFIXES), \
    tspec.get_mpc_plant_model()
OPTS = dict(fixed_heading_angle=0.0, fixed_velocity_angle=0.0,
            fixed_speed=0.3)


def _cfgs(**kw):
    """(JAX, port) env configs: the trainer's task (fixed command, partial
    observation) at cut budgets."""
    env = dict(max_time=20.0, frame_skip=2, obs_window=2, partial_obs=True,
               random_controls=True, max_contacts=8, solver_iterations=3)
    env.update(kw)
    return (jwalk.WalkingConfig(reset_options=jcommands.SampleOptions(**OPTS),
                                dtype=jnp.float64, **env),
            twalk.WalkingConfig(reset_options=tcommands.SampleOptions(**OPTS),
                                dtype=F64, **env))


PPO_KW = dict(num_envs=N, num_steps=T, epochs=2, num_minibatches=2,
              hidden=HIDDEN)


def _jax_train_state(jenv, seed=0):
    """A JAX TrainState with float64 parameters and envs that move: each
    env perturbed and at its own time."""
    jcfg = jppo.PPOConfig(**PPO_KW)
    ts = jppo.init_train_state(JM, jenv, jcfg, jax.random.PRNGKey(seed))
    params = jax.tree.map(lambda x: x.astype(jnp.float64), ts.params)
    rng = np.random.default_rng(seed)
    phys = ts.env_state.phys
    qpos = np.array(phys.qpos) + 0.02 * rng.standard_normal(phys.qpos.shape)
    qvel = 0.1 * rng.standard_normal(phys.qvel.shape)
    phys = phys._replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                         time=jnp.asarray([0.0, 0.1, 0.2, 0.3]))
    return ts._replace(params=params,
                       opt_state=jppo._optimizer(jcfg).init(params),
                       env_state=ts.env_state._replace(phys=phys))


def _jax_draws(key, n_act, epochs, n):
    """What JAX's rollout and epochs draw from ``key``: the action
    normals of each step, then the permutation of each epoch."""
    normals, perms = [], []
    for _ in range(T):
        key, k = jax.random.split(key)
        normals.append(np.asarray(jax.random.normal(k, (N, n_act),
                                                    jnp.float64)))
    for _ in range(epochs):
        key, k = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(k, n)))
    return normals, perms


def _inject(monkeypatch, normals, perms):
    normals, perms = iter(normals), iter(perms)

    def randn(shape, generator=None, dtype=None, device=None):
        z = torch.as_tensor(next(normals), dtype=dtype, device=device)
        assert tuple(z.shape) == tuple(shape)
        return z

    def randperm(n, generator=None, device=None):
        p = torch.as_tensor(next(perms), dtype=torch.int64, device=device)
        assert p.shape == (n,)
        return p

    monkeypatch.setattr(torch, "randn", randn)
    monkeypatch.setattr(torch, "randperm", randperm)


@functools.lru_cache(maxsize=None)
def _jax_updates():
    """(ts1, ts2, metrics of the second): two jitted JAX updates from a
    moving start; the port starts from ts1, whose Adam state is not
    fresh."""
    jenv, _ = _cfgs()
    update = jax.jit(jppo.update_fn(JM, jenv, jppo.PPOConfig(**PPO_KW)))
    ts1, _ = update(_jax_train_state(jenv))
    ts2, metrics = update(ts1)
    return ts1, ts2, metrics


def test_update_matches_jax(monkeypatch):
    ts1, ts2, want = _jax_updates()
    _, tenv = _cfgs()
    cfg = tppo.PPOConfig(**PPO_KW)
    ts = convert.train_state(ts1, cfg, seed=0, device="cpu")
    assert int(ts.update_idx) == 1
    assert float(ts.opt.state[ts.net.log_std]["step"]) == 4.0
    _inject(monkeypatch, *_jax_draws(ts1.key, TM.nu, cfg.epochs, N * T))
    got_ts, got = tppo.update_fn(TM, tenv, cfg)(ts)
    assert got_ts.net is ts.net and int(got_ts.update_idx) == 2
    for f in want._fields:
        _close(getattr(got, f), getattr(want, f), 1e-8, 1e-8, f)
    assert getattr(got, "reward_components").shape == (T, 11)
    adam = convert._adam_state(ts2.opt_state)
    for (t, w), (_, mu), (_, nu) in zip(
            convert._policy_pairs(ts.net, ts2.params),
            convert._policy_pairs(ts.net, adam.mu),
            convert._policy_pairs(ts.net, adam.nu)):
        _close(t, w, 1e-8, 1e-10, "params")
        _close(ts.opt.state[t]["exp_avg"], mu, 1e-8, 1e-12, "exp_avg")
        _close(ts.opt.state[t]["exp_avg_sq"], nu, 1e-8, 1e-14, "exp_avg_sq")
        assert float(ts.opt.state[t]["step"]) == int(adam.count) == 8
    _close(got_ts.obs, ts2.obs, 1e-7, 1e-9, "obs")
    _close(got_ts.env_state.phys.qpos, ts2.env_state.phys.qpos, 1e-8, 1e-10,
           "qpos")
    # the parameters moved
    assert not np.allclose(np.asarray(ts1.params["log_std"]),
                           np.asarray(ts2.params["log_std"]))


def test_lane_physics_rollout_matches_jax(monkeypatch):
    """``lane_physics=True``: the rollout's env steps through the
    batch-minor leg engine in both packages (JAX eagerly)."""
    steps = 2
    jenv, tenv = _cfgs(frame_skip=1)
    kw = dict(PPO_KW, num_steps=steps, lane_physics=True)
    ts1, _, _ = _jax_updates()
    obs = np.asarray(ts1.obs)
    normals, _ = _jax_draws(ts1.key, TM.nu, 0, 0)
    with jax.disable_jit():
        _, jobs, _, want = jppo._rollout(
            JM, jenv, jppo.PPOConfig(**kw), ts1.params, ts1.env_state,
            ts1.obs, ts1.key)
    ts = convert.train_state(ts1, tppo.PPOConfig(**kw), seed=0,
                             device="cpu")
    _inject(monkeypatch, normals[:steps], [])
    _, tobs, got = tppo._rollout(TM, tenv, tppo.PPOConfig(**kw), ts.net,
                                 ts.env_state, torch.as_tensor(obs),
                                 ts.generator)
    assert got.obs.shape == (steps, N, 52)
    _close(got.action, want.action, 1e-12, 1e-12, "action")
    _close(got.log_prob, want.log_prob, 1e-12, 1e-12, "log_prob")
    _close(got.value, want.value, 1e-12, 1e-12, "value")
    _close(got.obs, want.obs, 1e-7, 1e-9, "obs")
    _close(got.reward, want.reward, 1e-7, 1e-8, "reward")
    _close(got.reward_components, want.reward_components, 1e-7, 1e-8,
           "components")
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    _close(tobs, jobs, 1e-7, 1e-9, "last obs")
