"""Write the JAX package's gradient-solver results that the PyTorch port's
tests hold it to.

    python scripts/snapshot_torch_gradient_refs.py

A jitted JAX iLQR or SQP solve compiles for about three minutes on a CPU,
too long for the fast tests, so ``tests/test_torch_ilqr.py``,
``test_torch_sqp.py`` and ``test_torch_gradient_mpc.py`` compare the port
with the results this script saves in ``tests/torch_gradient_refs.npz``
(float64, on the CPU): ``ilqr.solve`` and ``sqp.solve`` at the JAX tests'
configuration (``tests/test_ilqr.py``, ``tests/test_sqp.py``), and one
SQP ``plan_and_act`` plus 3 steps of ``closed_loop`` at
``tests/test_gradient_mpc.py``'s, from a moving state on the floor (the
reset state dropped for 0.4 s, then a velocity perturbation from a seed)
and a warm-start plan off the standing hold (the hold plus noise from a
seed; both saved with the results). At the hold itself the posture
cost's norm has no derivative: JAX's is NaN there, which zeroes the SQP
step, torch's is 0. Their ``slow`` test recomputes the results live
and compares them with the file. The case definitions below are shared
with those tests.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "torch_gradient_refs.npz")

HOLD = np.array([0.0, 0.0, -0.5] * 4)
# the JAX tests' deliberately bad initial guess
BAD_GUESS = np.array([0.4, -0.4, 0.3] * 4)
SPEED = 0.2
# whole solves on the mpc_plant model from the reset state, exact cost
SOLVE_ROLLOUT = dict(horizon=4, frame_skip=1, max_contacts=8,
                     solver_iterations=2)
ILQR = dict(iterations=2, alphas=(1.0, 0.3, 0.1, 0.03, 0.0))
SQP = dict(iterations=2, alphas=(1.0, 0.3, 0.1, 0.03))
# receding-horizon SQP on the planning model, smoothed cost
MPC_ROLLOUT = dict(horizon=3, frame_skip=1, max_contacts=4,
                   solver_iterations=2)
MPC_SQP = dict(iterations=1, qp_iterations=5, alphas=(1.0, 0.1))
MPC_PLANT = dict(plant_frame_skip=1, plant_max_contacts=4,
                 plant_solver_iterations=2)
MPC_SMOOTH_EPS = 0.02
MPC_STEPS = 3
MPC_SETTLE_STEPS = 200
MPC_START_SEED = 0


def jax_results() -> dict:
    """Every reference array, computed by the JAX package (float64)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_enable_x64", True)
    from quadruped_gym_tpu.models import spec
    from quadruped_gym_tpu.physics import engine
    from quadruped_gym_tpu.runtime import mpc_runtime
    from quadruped_gym_tpu.solvers import ilqr, rollout, sqp
    from quadruped_gym_tpu.tasks import commands

    f64 = jnp.float64
    cmd = commands.make(jnp.asarray([SPEED, 0.0], f64), jnp.asarray(0.0, f64))
    prev = jnp.asarray(HOLD, f64)
    out = {}

    m = spec.get_model(collision_geom_prefixes=spec.MPC_COLLISION_PREFIXES)
    rcfg = rollout.RolloutConfig(**SOLVE_ROLLOUT)
    cost_fn = rollout.make_cost_fn(m)
    state0 = engine.make_state(m, dtype=f64)
    us0 = jnp.tile(jnp.asarray(BAD_GUESS, f64), (rcfg.horizon, 1))
    for name, mod, cfg in (
            ("ilqr", ilqr, ilqr.ILQRConfig(rollout=rcfg, **ILQR)),
            ("sqp", sqp, sqp.SQPConfig(rollout=rcfg, **SQP))):
        res = jax.jit(lambda s, u, mod=mod, cfg=cfg: mod.solve(
            m, cfg, cost_fn, s, u, cmd, prev))(state0, us0)
        for field, x in res._asdict().items():
            out[f"{name}_{field}"] = np.asarray(x)

    pm = spec.get_planning_model()
    cfg = mpc_runtime.MPCConfig(
        solver="sqp",
        sqp=sqp.SQPConfig(rollout=rollout.RolloutConfig(**MPC_ROLLOUT),
                          **MPC_SQP),
        **MPC_PLANT)
    cost_fn = rollout.make_cost_fn(pm, vel_smooth_eps=MPC_SMOOTH_EPS)
    carry = mpc_runtime.init_carry(pm, cfg, horizon=MPC_ROLLOUT["horizon"],
                                   key=jax.random.PRNGKey(0), dtype=f64)
    phys = engine.make_state(pm, dtype=f64)
    phys = jax.jit(lambda s: jax.lax.scan(
        lambda c, _: (engine.step(pm, c, prev, max_contacts=8,
                                  solver_iterations=4), None),
        s, None, length=MPC_SETTLE_STEPS)[0])(phys)
    rng = np.random.default_rng(MPC_START_SEED)
    phys = phys._replace(qvel=phys.qvel + jnp.asarray(
        0.1 * rng.standard_normal(pm.nv)))
    for field, x in phys._asdict().items():
        out[f"mpc_start_{field}"] = np.asarray(x)
    mean = np.clip(HOLD + 0.1 * rng.standard_normal(carry.mean.shape),
                   -1.0, 1.0)
    carry = carry._replace(mean=jnp.asarray(mean))
    out["mpc_start_mean"] = mean
    ctrl, carry1, info = jax.jit(lambda c, p: mpc_runtime.plan_and_act(
        pm, cfg, cost_fn, c, p, cmd))(carry, phys)
    out.update(mpc_plan_ctrl=np.asarray(ctrl),
               mpc_plan_mean=np.asarray(carry1.mean),
               mpc_plan_best_cost=np.asarray(info["best_cost"]),
               mpc_plan_mean_cost=np.asarray(info["mean_cost"]))
    _, end, (ctrls, sens, costs) = jax.jit(
        lambda c, p: mpc_runtime.closed_loop(pm, cfg, cost_fn, c, p, cmd,
                                             MPC_STEPS))(carry, phys)
    out.update(mpc_loop_ctrls=np.asarray(ctrls),
               mpc_loop_sensordata=np.asarray(sens),
               mpc_loop_best_cost=np.asarray(costs),
               mpc_loop_qpos=np.asarray(end.qpos),
               mpc_loop_qvel=np.asarray(end.qvel))
    return out


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, REPO)
    np.savez(OUT, **jax_results())
    print(f"wrote {OUT}")
