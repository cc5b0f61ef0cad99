"""Carry values across from the JAX package to this one.

What crosses between the two packages is state, and the policy's
parameters. Each function takes the JAX package's value as anything that
holds numpy arrays (or numpy-convertible arrays) under the same field
names, and returns the port's counterpart on ``device`` in ``dtype``. The
tests feed both packages through these.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .models.spec import DomainParams
from .ops.lane_engine import LaneState
from .physics.engine import State
from .rl import networks, ppo
from .runtime.mpc_runtime import MPCCarry
from .tasks.commands import Command
from .tasks.estimator import FreqAmpState
from .tasks.observations import PoObsCarry
from .tasks.rewards import RewardCarry
from .tasks.walking import WalkingState


def tensor(x, dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype,
                           device=resolve_device(device))


def _typed(x, dtype, device) -> torch.Tensor:
    """Like ``tensor``, but flags stay bool and counters become int64."""
    a = np.array(x)
    if a.dtype == np.bool_:
        dtype = torch.bool
    elif np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
    return torch.as_tensor(a, dtype=dtype, device=resolve_device(device))


def _fields(cls, src, dtype, device):
    return cls(**{f: _typed(getattr(src, f), dtype, device)
                  for f in cls._fields})


def state(src, dtype=torch.float64, device=None) -> State:
    """``physics.engine.State`` (qpos, qvel, act, time, sensordata)."""
    return _fields(State, src, dtype, device)


def lane_state(src, dtype=torch.float64, device=None) -> LaneState:
    """``ops.lane_engine.LaneState`` (batch-minor)."""
    return _fields(LaneState, src, dtype, device)


def command(src, dtype=torch.float64, device=None) -> Command:
    """``tasks.commands.Command``."""
    return _fields(Command, src, dtype, device)


def domain_params(src, dtype=torch.float64, device=None) -> DomainParams:
    """``models.spec.DomainParams``; None fields stay None."""
    return DomainParams(**{
        f: None if getattr(src, f) is None
        else tensor(getattr(src, f), dtype, device)
        for f in DomainParams._fields
    })


def mpc_carry(src, seed: int, dtype=torch.float64, device=None) -> MPCCarry:
    """``runtime.mpc_runtime.MPCCarry``: mean, sigma and prev_ctrl carry
    over; the JAX key does not (the two frameworks' random streams
    differ), so the port's generator is seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return MPCCarry(mean=tensor(src.mean, dtype, device),
                    sigma=tensor(src.sigma, dtype, device),
                    prev_ctrl=tensor(src.prev_ctrl, dtype, device),
                    generator=gen)


def reward_carry(src, dtype=torch.float64, device=None) -> RewardCarry:
    """``tasks.rewards.RewardCarry``; the two flags stay bool."""
    return _fields(RewardCarry, src, dtype, device)


def freq_amp_state(src, dtype=torch.float64, device=None) -> FreqAmpState:
    """``tasks.estimator.FreqAmpState``; index and count become int64."""
    return _fields(FreqAmpState, src, dtype, device)


def po_obs_carry(src, dtype=torch.float64, device=None) -> PoObsCarry:
    """``tasks.observations.PoObsCarry``."""
    return _fields(PoObsCarry, src, dtype, device)


def walking_state(src, dtype=torch.float64, device=None) -> WalkingState:
    """``tasks.walking.WalkingState`` of a batch of environments (leading
    axis N on every field). The JAX state's ``key`` does not carry over:
    the port's random stream is a generator that the caller holds."""
    return WalkingState(
        phys=state(src.phys, dtype, device),
        cmd=command(src.cmd, dtype, device),
        ideal_position=tensor(src.ideal_position, dtype, device),
        est=freq_amp_state(src.est, dtype, device),
        rew=reward_carry(src.rew, dtype, device),
        obs=po_obs_carry(src.obs, dtype, device),
        applied_ctrl=tensor(src.applied_ctrl, dtype, device),
    )


def _jax_policy_tree(src):
    """The JAX params tree ``{"actor": [{"b", "w"}, ...], "critic": [...],
    "log_std"}`` from itself or from the ``leaf_i`` of a checkpoint, whose
    flatten order is actor (b, w) per layer, critic (b, w) per layer,
    log_std. A layer continues the chain when its w takes the previous
    layer's width; the critic's first w takes the observation instead."""
    if "actor" in src:
        return src
    leaves = []
    while f"leaf_{len(leaves)}" in src:
        leaves.append(np.asarray(src[f"leaf_{len(leaves)}"]))

    def chain(i):
        layers = []
        while (i + 1 < len(leaves) and leaves[i + 1].ndim == 2
               and (not layers
                    or leaves[i + 1].shape[0] == layers[-1]["w"].shape[1])):
            layers.append({"b": leaves[i], "w": leaves[i + 1]})
            i += 2
        return layers, i

    actor, i = chain(0)
    critic, i = chain(i)
    return {"actor": actor, "critic": critic, "log_std": leaves[i]}


def _policy_pairs(net: networks.ActorCritic, tree):
    """(tensor of ``net``, JAX array) pairs: an ``nn.Linear`` weight is the
    transpose of the JAX layer's (in, out) ``w``."""
    for name in ("actor", "critic"):
        lins = net.linears(name)
        if len(lins) != len(tree[name]):
            raise ValueError(f"{name}: {len(tree[name])} JAX layers for "
                             f"{len(lins)} in the network")
        for lin, layer in zip(lins, tree[name]):
            yield lin.weight, np.asarray(layer["w"]).T
            yield lin.bias, np.asarray(layer["b"])
    yield net.log_std, np.asarray(tree["log_std"])


@torch.no_grad()
def policy_params(src, dtype=torch.float64,
                  device=None) -> networks.ActorCritic:
    """``rl.networks`` params of the JAX package, as a nested dict or as
    the ``leaf_i`` arrays of a JAX checkpoint (a policy's, or a train
    state's, whose leaves start with the params), as an
    ``ActorCritic``."""
    tree = _jax_policy_tree(src)
    actor = [np.asarray(layer["w"]) for layer in tree["actor"]]
    cfg = networks.NetConfig(
        obs_dim=actor[0].shape[0], act_dim=actor[-1].shape[1],
        hidden=tuple(w.shape[1] for w in actor[:-1]))
    net = networks.ActorCritic(cfg, dtype, device)
    for t, a in _policy_pairs(net, tree):
        t.copy_(torch.as_tensor(np.array(a)))
    return net


def _adam_state(opt_state):
    """optax's ``ScaleByAdamState`` (count, mu, nu) inside a chain's state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, tuple):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


def train_state(src, cfg: ppo.PPOConfig, seed: int, dtype=torch.float64,
                device=None) -> ppo.TrainState:
    """``rl.ppo.TrainState`` of the JAX package. optax's Adam state
    becomes torch Adam's: ``count`` -> ``step``, ``mu`` -> ``exp_avg``,
    ``nu`` -> ``exp_avg_sq``. The JAX key does not carry over: the port's
    generator is seeded with ``seed``."""
    device = resolve_device(device)
    net = policy_params(src.params, dtype, device)
    opt = ppo.make_optimizer(cfg, net)
    adam = _adam_state(src.opt_state)
    if adam is None:
        raise ValueError("no Adam state (count, mu, nu) in opt_state")
    with torch.no_grad():
        for (p, mu), (_, nu) in zip(_policy_pairs(net, adam.mu),
                                    _policy_pairs(net, adam.nu)):
            state = opt.state[p]
            state["step"] = torch.tensor(float(np.asarray(adam.count)))
            state["exp_avg"].copy_(torch.as_tensor(np.array(mu)))
            state["exp_avg_sq"].copy_(torch.as_tensor(np.array(nu)))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return ppo.TrainState(
        net=net, opt=opt,
        env_state=walking_state(src.env_state, dtype, device),
        obs=tensor(src.obs, dtype, device), generator=gen,
        update_idx=_typed(src.update_idx, dtype, device))
