"""Write the JAX package's lane-engine results that the PyTorch port's
tests hold it to.

    python scripts/snapshot_torch_lane_refs.py

The JAX lane engine unrolls every body, dof and contact slot at trace
time: jitted, one step compiles for minutes on a CPU; eager
(``jax.disable_jit``) it takes 13-25 s a step. So
``tests/test_torch_lane_engine.py`` compares the port with the results
this script saves in ``tests/torch_lane_refs.npz`` (float64, on the CPU,
about two minutes), recomputes one case live, and its ``slow`` test
recomputes them all. The cases below are shared with that test: states
made from numpy seeds around ``qpos0`` (in the air, or pressed to 3 cm so
that the feet, shins, ankle servos and, on ``full``, the base and hips
touch the ground), at Newton/line-search 4/8.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "torch_lane_refs.npz")
ITERATIONS = (4, 8)
HOLD = np.array([0.0, 0.0, -0.5] * 4)

# name -> (model snapshot, start, seed, batch, call, keyword arguments)
CASES = {
    "mpc_plant_air": ("mpc_plant", "air", 0, 4, "step", {}),
    "mpc_plant_contact": ("mpc_plant", "contact", 1, 4, "step", {}),
    "full_contact": ("full", "contact", 2, 4, "step", {}),
    # sensors from the last substep only
    "control_step": ("mpc_plant", "contact", 3, 4, "control_step",
                     {"frame_skip": 2}),
    "smooth": ("full", "contact", 4, 4, "step",
               {"solver_iterations": 0}),
    # the JAX package's (B/128, 128) TPU layout
    "tile": ("mpc_plant", "contact", 5, 128, "step", {"tile": True}),
}
# the case the fast tests recompute live
LIVE = "full_contact"


def case_inputs(name: str):
    """((qpos, qvel, act, time, sensordata) leading-batch, ctrl (nu, B)),
    float64 numpy. The model's ``qpos0`` comes from the port's snapshot
    (equal to the JAX package's model, tests/test_torch_model.py)."""
    from quadruped_gym_tpu_torch.models import spec

    model, start, seed, B, _, _ = CASES[name]
    m = spec.get_snapshot(model)
    rng = np.random.default_rng(seed)
    qpos = np.asarray(m.qpos0)[None] + 0.05 * rng.standard_normal((B, m.nq))
    if start == "air":
        qpos[:, 2] += 0.5
    else:
        qpos[:, 2] = 0.03
    qvel = 0.1 * rng.standard_normal((B, m.nv))
    act = np.tile(HOLD, (B, 1))
    sens = 0.1 * rng.standard_normal((B, m.nsensordata))
    ctrl = (np.array([0.1, -0.1, -0.5] * 4)[:, None]
            + 0.1 * rng.standard_normal((m.nu, B)))
    return (qpos, qvel, act, np.zeros(B), sens), ctrl


def jax_model(model: str):
    from quadruped_gym_tpu.models import spec

    if model == "mpc_plant":
        return spec.get_model(
            collision_geom_prefixes=spec.MPC_COLLISION_PREFIXES)
    return spec.get_model()


def jax_case(name: str) -> dict:
    """One case through the JAX lane engine, eagerly: {field: array}."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from quadruped_gym_tpu.ops import lane_engine

    model, _, _, _, call, kw = CASES[name]
    kw = dict(kw)
    it = kw.pop("solver_iterations", ITERATIONS[0])
    m = jax_model(model)
    batched, ctrl = case_inputs(name)
    ls = lane_engine.from_batched(*(jnp.asarray(x) for x in batched))
    with jax.disable_jit():
        if call == "step":
            out = lane_engine.step(m, ls, jnp.asarray(ctrl), it,
                                   ITERATIONS[1], **kw)
        else:
            out = lane_engine.control_step(m, ls, jnp.asarray(ctrl),
                                           kw.pop("frame_skip"), it,
                                           ITERATIONS[1], **kw)
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


def main():
    out = {}
    for name in CASES:
        print(f"{name} ...", flush=True)
        for f, x in jax_case(name).items():
            out[f"{name}_{f}"] = x
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
