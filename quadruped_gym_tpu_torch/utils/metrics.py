"""Reward-component CSV logging, same schema as the reference.

Counterpart of ``quadruped_gym_tpu/utils/metrics.py``: one row per
training step, ``step, total`` and one column per reward component
averaged over the env batch, appended to ``rewards_continuous.csv``. The
files are the JAX package's and the reference's, so either package's
analysis tools read them."""

from __future__ import annotations

import csv
import os
from typing import Sequence

import numpy as np

from ..tasks.rewards import REWARD_KEYS


class RewardCSVLogger:
    """Append-only CSV of per-step mean reward components."""

    def __init__(self, path: str, keys: Sequence[str] = REWARD_KEYS):
        self.path = path
        self.keys = tuple(keys)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fresh = not os.path.exists(path)
        self._fh = open(path, "a", newline="")
        self._writer = csv.writer(self._fh)
        if fresh:
            self._writer.writerow(("step", "total") + self.keys)
            self._fh.flush()

    def log(self, step: int, components: np.ndarray) -> None:
        """components: (n_components,) means over the env batch."""
        comp = np.asarray(components, float)
        self._writer.writerow([step, float(comp.sum())]
                              + [float(c) for c in comp])

    def log_many(self, start_step: int, components: np.ndarray) -> None:
        """components: (steps, n_components), a whole training chunk."""
        comp = np.asarray(components, float)
        for i in range(comp.shape[0]):
            self.log(start_step + i, comp[i])
        self.flush()

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


def read_reward_csv(path: str):
    """(steps, totals, components (n, k), keys) from a logger CSV."""
    with open(path) as f:
        rows = list(csv.reader(f))
    keys = tuple(rows[0][2:])
    data = np.asarray([[float(x) for x in r] for r in rows[1:]], float)
    if data.size == 0:
        return np.zeros(0), np.zeros(0), np.zeros((0, len(keys))), keys
    return data[:, 0].astype(int), data[:, 1], data[:, 2:], keys
