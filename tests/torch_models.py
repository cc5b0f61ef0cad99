"""Models the port's tests share beyond the committed snapshots."""

import dataclasses
import functools

import numpy as np

from quadruped_gym_tpu_torch.models import spec


@functools.lru_cache(maxsize=None)
def incompatible_full():
    """``full`` with leg 0's shin body 10 % heavier: its legs differ, so it
    is not leg-compatible and every route takes the lane engine (the
    model the fallback tests step since ``full`` itself became
    leg-compatible)."""
    m = spec.get_full_model()
    mass = np.array(m.body_mass, dtype=np.float64, copy=True)
    mass[3] *= 1.1  # body 3: the level-1 body (shin) of leg 0
    return dataclasses.replace(m, body_mass=mass)
