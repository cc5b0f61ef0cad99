"""Write the JAX package's stages of one gait SQP iteration that the
PyTorch port's ``scripts/torch_diag_gait.py`` is held to.

    python scripts/snapshot_torch_diag_gait_refs.py

Runs the stages of ``scripts/diag_gait.py`` as that script runs them (each
stage jitted, in float64 on the CPU) at ``CASE``: the fast plant at H=2,
the stance settled by ``examples/gait_sqp.py::settle_state``, the sine
warm start, AD linearization. Saves the settled state, the warm start and
every stage's arrays in ``tests/torch_diag_gait_refs.npz``.
``tests/test_torch_research.py`` feeds the port's stages the same state and
warm start and compares them with the file; its ``slow`` test recomputes
the file's contents live.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "torch_diag_gait_refs.npz")

# diag_gait.py's flags for the case: --horizon 2 --f64, the rest default
CASE = dict(horizon=2, frame_skip=5, linearize="ad", smooth_eps=0.02,
            eps=1e-5)
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
REG = 1e-3


def jax_stages() -> dict:
    """Every array of the case, computed by the JAX package (float64)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, REPO)
    from examples.gait_sqp import HOLD, settle_state, sine_warm_start
    from quadruped_gym_tpu.models import spec
    from quadruped_gym_tpu.physics import engine
    from quadruped_gym_tpu.solvers import ilqr as ilqr_mod
    from quadruped_gym_tpu.solvers import rollout, sqp
    from quadruped_gym_tpu.tasks import commands

    dtype = jnp.float64
    m = spec.get_fast_plant_model()
    H, fs = CASE["horizon"], CASE["frame_skip"]
    rcfg = rollout.RolloutConfig(horizon=H, frame_skip=fs, max_contacts=12,
                                 solver_iterations=4)
    cost_fn = rollout.make_cost_fn(m, vel_smooth_eps=CASE["smooth_eps"])
    cmd = commands.make(jnp.asarray([0.2, 0.0], dtype),
                        jnp.asarray(0.0, dtype))
    prev = jnp.asarray(HOLD, dtype)
    us0 = sine_warm_start(H, fs * 0.002, dtype)
    state0 = settle_state(m, dtype)

    def step_fn(st, u):
        return engine.control_step(
            m, st, u, rcfg.frame_skip, max_contacts=rcfg.max_contacts,
            solver_iterations=rcfg.solver_iterations)

    def traj_rollout(us):
        def body(carry, u):
            st, pv = carry
            st2 = step_fn(st, u)
            c = cost_fn(st2.sensordata, u, pv, cmd)
            return (st2, u), (st2, c)
        (_, _), (states, costs) = jax.lax.scan(body, (state0, prev), us)
        return states, jnp.sum(costs)

    out = {f"state0_{f}": np.asarray(getattr(state0, f))
           for f in state0._fields}
    out["us0"] = np.asarray(us0)
    states, cost0 = jax.jit(traj_rollout)(us0)
    out.update(states_qpos=np.asarray(states.qpos),
               states_qvel=np.asarray(states.qvel),
               cost0=np.asarray(cost0))
    lin = ilqr_mod.make_linearizer(CASE["linearize"])
    A, B = jax.jit(lambda s, u: lin(m, step_fn, state0, s, u, CASE["eps"]))(
        states, us0)
    lx, lxx, lu, luu = jax.jit(
        lambda s, u: ilqr_mod.quadratize_cost(m, cost_fn, cmd, s, u, prev)
    )(states, us0)
    F = jax.jit(sqp.sensitivities)(A, B)
    Hqp, g = jax.jit(sqp.condense)(F, lx, lxx)
    Hqp, g = jax.jit(sqp._add_control_blocks)(Hqp, g, lu, luu)
    Hs = 0.5 * (np.asarray(Hqp, np.float64) + np.asarray(Hqp, np.float64).T)
    nu = us0.shape[1]
    lo_u = jnp.asarray(np.asarray(m.actuator_ctrlrange[:, 0]), dtype)
    hi_u = jnp.asarray(np.asarray(m.actuator_ctrlrange[:, 1]), dtype)
    Hreg = jnp.asarray(Hs, dtype) + REG * jnp.eye(H * nu, dtype=dtype)
    lo = jnp.tile(lo_u, H) - us0.reshape(-1)
    hi = jnp.tile(hi_u, H) - us0.reshape(-1)
    du = jax.jit(sqp.admm_box_qp)(Hreg, g, lo, hi)
    du_z = jnp.where(jnp.isfinite(du), du, 0.0).reshape(H, nu)
    roll_j = jax.jit(lambda u: traj_rollout(u)[1])
    ls = [roll_j(jnp.clip(us0 + a * du_z, lo_u, hi_u)) for a in ALPHAS]
    for name, x in (("A", A), ("B", B), ("lx", lx), ("lxx", lxx),
                    ("lu", lu), ("luu", luu), ("F", F), ("Hqp", Hqp),
                    ("g", g), ("du", du)):
        out[name] = np.asarray(x)
    out["line_search_costs"] = np.asarray(ls)
    return out


if __name__ == "__main__":
    np.savez(OUT, **jax_stages())
    print("wrote", OUT)
