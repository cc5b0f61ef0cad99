"""``launches_per_step.env``: the card's kernels, copies and sets per env
step over the traced window: what the host issues for the actor, the
task layer, the kernel wrapper and the auto-reset. None without a trace
that saw the card."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.events:
        return None
    return len(ctx.trace.events) / len(ctx.requests)
