"""``b2_busy_share_pct.full_env``: the substep kernel's (B2) device time
over the traced window's busy time (%): whether B2 or the CUDA graph's
small operations beside it (the task layer, the auto-reset, the actor)
set the pace of an env step. None where the trace saw no B2."""


def read(ctx):
    if ctx.trace is None:
        return None
    evs = ctx.trace.kernels("substep_kernel")
    busy = ctx.trace.busy_s()
    if not evs or busy <= 0.0:
        return None
    return 100.0 * sum(ev.end_us - ev.start_us for ev in evs) * 1e-6 / busy
