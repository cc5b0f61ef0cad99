"""Write the JAX package's data-parallel PPO update that the PyTorch
port's tests hold it to.

    python scripts/snapshot_torch_parallel_refs.py

One ``rl.distributed.make_distributed_update`` of the JAX package on a
mesh of 2 virtual CPU devices (``shard_map``, float64), at a tiny size:
``mpc_plant``, 4 envs (2 a shard) that move, 2 env steps, 1 epoch of 1
minibatch, hidden (16,), 8 contacts, 2 Newton passes. It saves, in
``tests/torch_parallel_refs.npz``:

- ``init/leaf_i``: the starting TrainState in the port's checkpoint
  order (``runtime/checkpoint.py``), the envs global;
- ``normals/r/t`` and ``perms/r/e``: what shard r draws from
  ``fold_in(key, r)``: the action normals of each env step, the
  permutation of each epoch (the two frameworks draw different numbers
  from a seed, so the port's ranks are handed these);
- ``want/leaf_i``: the updated network in the order of the port's
  ``state_dict``, and ``metrics/<field>``: the update's metrics (the
  mean over the shards).

``tests/test_torch_distributed_ppo.py`` feeds the port's two gloo ranks
the same start and draws; its ``slow`` test recomputes this file live.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "torch_parallel_refs.npz")
SHARDS = 2
PPO_KW = dict(num_envs=4, num_steps=2, epochs=1, num_minibatches=1,
              hidden=(16,))
ENV_KW = dict(max_time=20.0, frame_skip=2, obs_window=2, partial_obs=True,
              random_controls=True, max_contacts=8, solver_iterations=2)
RESET = dict(fixed_heading_angle=0.0, fixed_velocity_angle=0.0,
             fixed_speed=0.3)
SEED = 0

if "xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_"
                               f"force_host_platform_device_count={SHARDS}")
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def port_configs():
    """(env config, PPO config) of the port, float64."""
    import torch

    from quadruped_gym_tpu_torch.rl import ppo
    from quadruped_gym_tpu_torch.tasks import commands, walking

    return (walking.WalkingConfig(
        reset_options=commands.SampleOptions(**RESET), dtype=torch.float64,
        **ENV_KW), ppo.PPOConfig(**PPO_KW))


def _jax_train_state(jm, jenv, jcfg):
    """The JAX TrainState: float64 parameters, each env perturbed, moving
    and at its own time (from rest the direction reward's v/|v| amplifies
    rounding)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from quadruped_gym_tpu.rl import ppo as jppo

    ts = jppo.init_train_state(jm, jenv, jcfg, jax.random.PRNGKey(SEED))
    params = jax.tree.map(lambda x: x.astype(jnp.float64), ts.params)
    rng = np.random.default_rng(SEED)
    phys = ts.env_state.phys
    qpos = np.array(phys.qpos) + 0.02 * rng.standard_normal(phys.qpos.shape)
    qvel = 0.1 * rng.standard_normal(phys.qvel.shape)
    phys = phys._replace(qpos=jnp.asarray(qpos), qvel=jnp.asarray(qvel),
                         time=jnp.asarray(0.1 * np.arange(qpos.shape[0])))
    return ts._replace(params=params,
                       opt_state=jppo._optimizer(jcfg).init(params),
                       env_state=ts.env_state._replace(phys=phys))


def jax_results() -> dict:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from quadruped_gym_tpu import parallel as jparallel
    from quadruped_gym_tpu.models import spec as jspec
    from quadruped_gym_tpu.rl import distributed as jdist
    from quadruped_gym_tpu.rl import ppo as jppo
    from quadruped_gym_tpu.tasks import commands as jcommands
    from quadruped_gym_tpu.tasks import walking as jwalk
    from quadruped_gym_tpu_torch import convert
    from quadruped_gym_tpu_torch.runtime import checkpoint

    jm = jspec.get_model(collision_geom_prefixes=jspec.MPC_COLLISION_PREFIXES)
    jenv = jwalk.WalkingConfig(
        reset_options=jcommands.SampleOptions(**RESET), dtype=jnp.float64,
        **ENV_KW)
    jcfg = jppo.PPOConfig(**PPO_KW)
    ts = _jax_train_state(jm, jenv, jcfg)
    mesh = jparallel.make_mesh(jax.devices("cpu")[:SHARDS],
                               axis_names=(jparallel.DATA_AXIS,))
    new_ts, metrics = jax.jit(
        jdist.make_distributed_update(jm, jenv, jcfg, mesh))(ts)

    out = {}
    _, tcfg = port_configs()
    start = convert.train_state(ts, tcfg, seed=SEED, device="cpu")
    for i, x in enumerate(checkpoint._leaves(start)):
        out[f"init/leaf_{i}"] = checkpoint._numpy(x)
    net = convert.policy_params(new_ts.params, device="cpu")
    for i, x in enumerate(net.state_dict().values()):
        out[f"want/leaf_{i}"] = x.numpy()
    for f in metrics._fields:
        out[f"metrics/{f}"] = np.asarray(getattr(metrics, f))
    n_local = jcfg.num_envs // SHARDS
    nu = jm.nu
    for r in range(SHARDS):
        key = jax.random.fold_in(ts.key, r)
        for t in range(jcfg.num_steps):
            key, k = jax.random.split(key)
            out[f"normals/{r}/{t}"] = np.asarray(
                jax.random.normal(k, (n_local, nu), jnp.float64))
        for e in range(jcfg.epochs):
            key, k = jax.random.split(key)
            out[f"perms/{r}/{e}"] = np.asarray(jax.random.permutation(
                k, n_local * jcfg.num_steps))
    return out


def main():
    import numpy as np

    out = jax_results()
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: {len(out)} arrays")


if __name__ == "__main__":
    main()
