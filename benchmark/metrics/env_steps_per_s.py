"""``env_steps_per_s``: environment steps (environments x steps) the
window completed, each ending in a synchronise, over the window's time
from the first step's call to the last step's end."""

from benchmark.harness import rate as read  # noqa: F401
