"""Observability: the reward CSV of training, static plots and the live
dashboard (``server.launch_dash``).

Counterpart of ``quadruped_gym_tpu/utils``; ``profiling.py`` is not
ported yet (ROADMAP.md A.15)."""

from .metrics import RewardCSVLogger, read_reward_csv  # noqa: F401
from .plot import (  # noqa: F401
    moving_average,
    plot_data,
    plot_data_line,
    plot_reward_components,
)
