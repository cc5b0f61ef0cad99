"""``rollouts_per_s``: rollouts scored in the solves the window completed
(a solve is complete when its control is on the host), over the window's
time from the first call to the last answer. All the work over all the
time: the window ends with a whole solve."""

from benchmark.harness import rate as read  # noqa: F401
