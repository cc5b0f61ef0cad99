"""``b2_warps_per_sm.full_env``: the warps of the substep kernel (B2) an SM
holds at once at the launch the program made, threads a block times
resident blocks an SM over 32, from the program's counter
``ops.cuda_engine.geometry["substep"]`` (the CUDA occupancy API on the
built kernel at the launch's block and shared sizes, set by the wrapper's
last launch or graph capture). None where the program keeps no such
counter or launched no B2."""


def read(ctx):
    from quadruped_gym_tpu_torch.ops import cuda_engine

    geo = getattr(cuda_engine, "geometry", {}).get("substep")
    if not geo:
        return None
    return geo["threads"] * geo["blocks_per_sm"] / 32
