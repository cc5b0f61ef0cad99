"""Actor-critic networks.

Counterpart of ``quadruped_gym_tpu/rl/networks.py``: separate actor and
critic MLPs with tanh between layers and orthogonal initialisation
(hidden layers scaled by sqrt(2), the actor's output by 0.01, the
critic's by 1.0), and a state-independent log-std Gaussian head. The
network is an ``nn.Module``; the functions below it have the JAX
package's names and formulas. Initialisation draws from a
``torch.Generator``, so it is not bit-equal to JAX's; ``convert.
policy_params`` carries JAX parameters across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch
from torch import nn

from .._device import resolve_device
from ..utils import profiling


@dataclasses.dataclass(frozen=True)
class NetConfig:
    obs_dim: int
    act_dim: int
    hidden: Tuple[int, ...] = (256, 256, 128)
    init_log_std: float = 0.0


def _orthogonal_(weight: torch.Tensor, scale: float,
                 generator: torch.Generator) -> None:
    """Fill an (out, in) ``nn.Linear`` weight as the JAX package fills its
    (in, out) matrix: QR of a standard normal draw with the sign of R's
    diagonal folded into Q, times ``scale``."""
    rows, cols = weight.shape[1], weight.shape[0]  # the JAX (in, out)
    a = torch.randn((rows, cols), generator=generator, dtype=torch.float32,
                    device=generator.device)
    q, r = torch.linalg.qr(a if rows >= cols else a.T)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    weight.copy_((scale * q[:rows, :cols]).T)


def _mlp(sizes: Sequence[int], dtype, device) -> nn.Sequential:
    layers = []
    for i in range(len(sizes) - 1):
        layers.append(nn.Linear(sizes[i], sizes[i + 1], dtype=dtype,
                                device=device))
        if i < len(sizes) - 2:
            layers.append(nn.Tanh())
    return nn.Sequential(*layers)


class ActorCritic(nn.Module):
    """``actor`` and ``critic`` MLPs (``nn.Sequential`` of ``nn.Linear``
    and ``nn.Tanh``) and the ``log_std`` parameter. Built with zero
    weights; ``init`` draws them."""

    def __init__(self, cfg: NetConfig, dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.actor = _mlp((cfg.obs_dim, *cfg.hidden, cfg.act_dim), dtype,
                          device)
        self.critic = _mlp((cfg.obs_dim, *cfg.hidden, 1), dtype, device)
        self.log_std = nn.Parameter(torch.full(
            (cfg.act_dim,), cfg.init_log_std, dtype=dtype, device=device))

    def linears(self, name: str):
        return [m for m in getattr(self, name) if isinstance(m, nn.Linear)]


@torch.no_grad()
def init(generator: torch.Generator, cfg: NetConfig,
         dtype=torch.float32) -> ActorCritic:
    """A freshly initialised network on the generator's device."""
    net = ActorCritic(cfg, dtype, generator.device)
    for name, out_scale in (("actor", 0.01), ("critic", 1.0)):
        lins = net.linears(name)
        for i, lin in enumerate(lins):
            scale = out_scale if i == len(lins) - 1 else math.sqrt(2.0)
            _orthogonal_(lin.weight, scale, generator)
            lin.bias.zero_()
    return net


def actor_mean(net: ActorCritic, obs: torch.Tensor) -> torch.Tensor:
    return net.actor(obs)


def value(net: ActorCritic, obs: torch.Tensor) -> torch.Tensor:
    return net.critic(obs)[..., 0]


def sample_action(net: ActorCritic, obs: torch.Tensor,
                  generator: torch.Generator):
    """(action, log_prob) under the diagonal Gaussian policy."""
    with profiling.span("networks.sample_action"):
        mean = actor_mean(net, obs)
        std = torch.exp(net.log_std)
        eps = torch.randn(mean.shape, generator=generator, dtype=mean.dtype,
                          device=mean.device)
        action = mean + std * eps
        logp = gaussian_log_prob(mean, net.log_std, action)
        return action, logp


def gaussian_log_prob(mean, log_std, action):
    std = torch.exp(log_std)
    z = (action - mean) / std
    return torch.sum(-0.5 * z**2 - log_std - 0.5 * math.log(2.0 * math.pi),
                     dim=-1)


def entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e))
