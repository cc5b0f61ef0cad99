"""Observability: the reward CSV of training.

Counterpart of ``quadruped_gym_tpu/utils``; its plots (``plot.py``) and
dashboard (``server.py``) are not ported yet (ROADMAP.md)."""

from .metrics import RewardCSVLogger, read_reward_csv  # noqa: F401
