"""``setup_s``: seconds from the start of ``benchmark/run.py`` to the first
timed request: imports, the program's set-up, the kernels' build where
missing, and the warm-up of the cell's own shapes."""


def read(ctx):
    return ctx.setup_s
