"""Environments: the gym-level classes and the batched walking env.

Counterpart of ``quadruped_gym_tpu/envs``: the gymnasium-compatible
classes step one environment on the oracle engine
(``gym_env.py``, drawn by ``rendering.py``); ``VectorWalkingEnv`` steps
thousands on the card (``vector_env.py``).
"""

from .gym_env import (  # noqa: F401
    DummyWalkingQuadrupedEnv,
    POWalkingQuadrupedEnv,
    QuadrupedEnv,
    VelocityHeadingControls,
    WalkingQuadrupedEnv,
)
from .vector_env import VectorStepOutput, VectorWalkingEnv  # noqa: F401
