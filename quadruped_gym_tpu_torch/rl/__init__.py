"""Reinforcement learning (PPO) for the walking task.

Counterpart of ``quadruped_gym_tpu/rl``: the rollout, GAE and minibatch
epochs of an update all run on the card over thousands of batched
envs; ``evaluate`` plays a policy through the gym env; ``distributed``
cuts the env batch over the ranks of a ``torch.distributed`` mesh and
averages the gradients across them.
"""

from . import distributed, evaluate, networks, ppo  # noqa: F401
from .ppo import (  # noqa: F401
    PPOConfig,
    TrainState,
    UpdateMetrics,
    init_train_state,
    train_chunk,
    update_fn,
)
