"""Observability: the reward CSV of training, static plots, the live
dashboard (``server.launch_dash``) and the card's traces and roofline
accounting (``profiling``).

Counterpart of ``quadruped_gym_tpu/utils``, every module of it ported."""

from .metrics import RewardCSVLogger, read_reward_csv  # noqa: F401
from .plot import (  # noqa: F401
    moving_average,
    plot_data,
    plot_data_line,
    plot_reward_components,
)
