"""PPO on the card: rollout and update of thousands of envs in one process.

Counterpart of ``quadruped_gym_tpu/rl/ppo.py``. Each ``lax.scan`` of the
JAX package is a Python loop here: the rollout over ``num_steps``, GAE
backwards over them, and the epochs of minibatch steps. Nothing inside an
update reads a value back to the host, so the card runs ahead of the
Python loop. The JAX package's ``key`` is the ``torch.Generator`` in
``TrainState``: actions, epoch permutations and the env resets draw from
it, in that program order.

Hyperparameters default to SB3's PPO defaults, as in the JAX package. The
optimizer is ``torch.optim.Adam`` behind a global-norm clip written to
optax's formula, so an update is optax's ``chain(clip_by_global_norm,
adam)`` up to rounding.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..envs import vector_env
from ..models.spec import PhysicsModel
from ..tasks import walking
from . import networks


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    num_envs: int = 2048
    num_steps: int = 32  # rollout length per update
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    epochs: int = 4
    num_minibatches: int = 8
    vf_coef: float = 0.5
    ent_coef: float = 0.0
    max_grad_norm: float = 0.5
    hidden: Tuple[int, ...] = (256, 256, 128)
    # optional bounds on the state-independent log-std head, applied after
    # each minibatch step (a fine-tune phase with log_std_max ~ -1.2 makes
    # the sampled policy walk; see the JAX package's PPOConfig)
    log_std_min: Optional[float] = None
    log_std_max: Optional[float] = None
    # env physics through the batch-minor leg engine
    # (vector_env.batched_autoreset_step) instead of the oracle engine
    lane_physics: bool = False

    @property
    def batch_size(self) -> int:
        return self.num_envs * self.num_steps


class TrainState(NamedTuple):
    """``update_fn`` changes ``net``, ``opt`` and ``generator`` in place
    and returns a TrainState that holds the same three objects."""

    net: networks.ActorCritic
    opt: torch.optim.Adam
    env_state: walking.WalkingState  # leading axis num_envs
    obs: torch.Tensor  # (num_envs, obs_dim)
    generator: torch.Generator
    update_idx: torch.Tensor  # () int64, on the card


class UpdateMetrics(NamedTuple):
    mean_reward: torch.Tensor
    mean_episode_done: torch.Tensor
    pg_loss: torch.Tensor
    vf_loss: torch.Tensor
    entropy: torch.Tensor
    approx_kl: torch.Tensor
    # (num_steps, 11): one row per policy step, averaged over the env batch
    # (the reference's CSV granularity)
    reward_components: torch.Tensor


def make_optimizer(cfg: PPOConfig, net: networks.ActorCritic):
    """Adam with optax's ``eps=1e-5``, its state made up front (zero
    moments, step 0) as optax's ``init`` does, so that a fresh state
    checkpoints like a trained one."""
    opt = torch.optim.Adam(net.parameters(), lr=cfg.learning_rate, eps=1e-5)
    for p in net.parameters():
        opt.state[p] = {"step": torch.tensor(0.0),
                        "exp_avg": torch.zeros_like(p),
                        "exp_avg_sq": torch.zeros_like(p)}
    return opt


def init_train_state(m: PhysicsModel, env_cfg: walking.WalkingConfig,
                     cfg: PPOConfig, seed: int, device=None) -> TrainState:
    """A fresh network, optimizer and batch of envs on ``device`` (the
    card unless ``device="cpu"``), all drawn from one generator seeded
    with ``seed``. The network takes ``env_cfg.dtype``: the JAX package
    keeps its parameters float32, which is the same for the default
    float32 env."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    net_cfg = networks.NetConfig(obs_dim=walking.obs_size(env_cfg, m),
                                 act_dim=m.nu, hidden=cfg.hidden)
    net = networks.init(gen, net_cfg, dtype=env_cfg.dtype)
    env_state, obs = walking.reset(m, env_cfg, cfg.num_envs, gen)
    return TrainState(net=net, opt=make_optimizer(cfg, net),
                      env_state=env_state, obs=obs, generator=gen,
                      update_idx=torch.zeros((), dtype=torch.int64,
                                             device=device))


class _Transition(NamedTuple):
    obs: torch.Tensor
    action: torch.Tensor
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor  # bool
    reward_components: torch.Tensor


@torch.no_grad()
def _rollout(m, env_cfg, cfg: PPOConfig, net, env_state, obs,
             generator: torch.Generator):
    """``num_steps`` env steps; returns (env_state, obs, transitions
    stacked on a leading time axis)."""
    step = (vector_env.batched_autoreset_step if cfg.lane_physics
            else vector_env.autoreset_step)
    trs = []
    for _ in range(cfg.num_steps):
        action, logp = networks.sample_action(net, obs, generator)
        val = networks.value(net, obs)
        out = step(m, env_cfg, env_state, torch.clamp(action, -1.0, 1.0),
                   generator)
        trs.append(_Transition(obs=obs, action=action, log_prob=logp,
                               value=val, reward=out.reward, done=out.done,
                               reward_components=out.reward_components))
        env_state, obs = out.state, out.obs
    traj = _Transition(*(torch.stack(x) for x in zip(*trs)))
    return env_state, obs, traj


@torch.no_grad()
def _gae(cfg: PPOConfig, traj: _Transition, last_value):
    not_done = 1.0 - traj.done.to(traj.value.dtype)
    gae, next_value = torch.zeros_like(last_value), last_value
    advantages = [None] * traj.value.shape[0]
    for t in reversed(range(traj.value.shape[0])):
        delta = (traj.reward[t] + cfg.gamma * next_value * not_done[t]
                 - traj.value[t])
        gae = delta + cfg.gamma * cfg.gae_lambda * not_done[t] * gae
        next_value = traj.value[t]
        advantages[t] = gae
    advantages = torch.stack(advantages)
    return advantages, advantages + traj.value


def _loss_fn(net, cfg: PPOConfig, batch):
    obs, action, old_logp, old_value, adv, ret = batch
    mean = networks.actor_mean(net, obs)
    logp = networks.gaussian_log_prob(mean, net.log_std, action)
    val = networks.value(net, obs)

    ratio = torch.exp(logp - old_logp)
    # population std, as jnp.std
    adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps) * adv_n
    pg_loss = -torch.mean(torch.minimum(pg1, pg2))

    vf_loss = 0.5 * torch.mean((val - ret) ** 2)
    ent = networks.entropy(net.log_std)
    total = pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * ent
    approx_kl = torch.mean(old_logp - logp)
    return total, (pg_loss, vf_loss, ent, approx_kl)


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax's ``clip_by_global_norm`` on the ``.grad`` of ``params``:
    ``g`` where the global norm is below ``max_norm``, else
    ``g / norm * max_norm`` (``clip_grad_norm_`` divides by
    ``norm + 1e-6`` instead). No value leaves the card."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@torch.no_grad()
def clamp_log_std_(net: networks.ActorCritic, cfg: PPOConfig) -> None:
    if cfg.log_std_min is not None or cfg.log_std_max is not None:
        net.log_std.clamp_(cfg.log_std_min, cfg.log_std_max)


def update_fn(m: PhysicsModel, env_cfg: walking.WalkingConfig,
              cfg: PPOConfig, axis_name: Optional[str] = None, mesh=None):
    """One PPO update (rollout + epochs of minibatch steps) as a function
    of the TrainState.

    With ``axis_name`` (an axis of ``mesh``, ``parallel.make_mesh``) each
    minibatch's gradients are averaged over the axis's ranks before the
    clip and Adam: data parallelism, each rank rolling out its own envs
    (``rl/distributed.py``)."""
    group = None
    if axis_name is not None:
        if mesh is None:
            raise ValueError(f"axis_name={axis_name!r} needs the mesh that "
                             "holds the axis")
        group = mesh.get_group(axis_name)

    def update(ts: TrainState) -> Tuple[TrainState, UpdateMetrics]:
        env_state, obs, traj = _rollout(m, env_cfg, cfg, ts.net,
                                        ts.env_state, ts.obs, ts.generator)
        metrics = _optimize(cfg, ts.net, ts.opt, ts.generator, traj, obs,
                            group)
        new_ts = ts._replace(env_state=env_state, obs=obs,
                             update_idx=ts.update_idx + 1)
        return new_ts, metrics

    return update


@torch.no_grad()
def mean_grads_(params, group) -> None:
    """The ``.grad`` of ``params`` averaged over the ranks of ``group``
    (JAX's ``pmean``): one SUM all-reduce of a flat buffer, then a
    division (gloo has no AVG)."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, dist.ReduceOp.SUM, group=group)
    flat /= dist.get_world_size(group)
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.reshape(g.shape))


def _optimize(cfg: PPOConfig, net, opt, gen: torch.Generator,
              traj: _Transition, last_obs, group=None) -> UpdateMetrics:
    """The learning half of an update: GAE from the value of the obs the
    rollout ended on, then ``epochs`` passes of ``num_minibatches``
    clipped Adam steps over a fresh permutation each (their gradients
    averaged over ``group``'s ranks first, where one is given)."""
    with torch.no_grad():
        last_value = networks.value(net, last_obs)
    adv, ret = _gae(cfg, traj, last_value)

    # flatten (T, N, ...) -> (T*N, ...)
    flat = tuple(x.reshape((-1,) + x.shape[2:]) for x in (
        traj.obs, traj.action, traj.log_prob, traj.value, adv, ret))
    n = flat[0].shape[0]
    mb_size = n // cfg.num_minibatches
    params = list(net.parameters())
    for _ in range(cfg.epochs):
        perm = torch.randperm(n, generator=gen, device=flat[0].device)
        shuffled = tuple(x[perm] for x in flat)
        for i in range(cfg.num_minibatches):
            mb = tuple(x[i * mb_size:(i + 1) * mb_size] for x in shuffled)
            opt.zero_grad(set_to_none=True)
            loss, aux = _loss_fn(net, cfg, mb)
            loss.backward()
            if group is not None:
                mean_grads_(params, group)
            clip_by_global_norm_(params, cfg.max_grad_norm)
            opt.step()
            clamp_log_std_(net, cfg)
    pg, vf, ent, kl = (x.detach() for x in aux)
    return UpdateMetrics(
        mean_reward=traj.reward.mean(),
        mean_episode_done=traj.done.to(traj.reward.dtype).mean(),
        pg_loss=pg, vf_loss=vf, entropy=ent, approx_kl=kl,
        reward_components=traj.reward_components.mean(dim=1),
    )


def train_chunk(m: PhysicsModel, env_cfg: walking.WalkingConfig,
                cfg: PPOConfig, ts: TrainState, num_updates: int,
                update=None):
    """``num_updates`` PPO updates (of ``update``, by default
    ``update_fn(m, env_cfg, cfg)``). Returns (train_state, UpdateMetrics
    stacked on a leading update axis); nothing is read back to the host."""
    if update is None:
        update = update_fn(m, env_cfg, cfg)
    history = []
    for _ in range(num_updates):
        ts, metrics = update(ts)
        history.append(metrics)
    return ts, UpdateMetrics(*(torch.stack(x) for x in zip(*history)))
