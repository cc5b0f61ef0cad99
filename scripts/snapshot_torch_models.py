"""Write the PyTorch port's model snapshots from the JAX package's models.

    python scripts/snapshot_torch_models.py

Needs MuJoCo (the JAX package compiles the MJCF with it). Writes
``quadruped_gym_tpu_torch/models/assets/{feet,mpc_plant,full}.npz``: the
full-hull models of the feet-only collision set (the base of
``get_planning_model``), of the lower-leg set (the closed-loop plant and
the base of ``get_fast_plant_model``) and of every collidable geom. The
port loads them in place of the MJCF build and derives the decimated
models itself (bit-identical files when nothing changed).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quadruped_gym_tpu.models import spec as jax_spec  # noqa: E402
from quadruped_gym_tpu_torch.models import spec  # noqa: E402

if __name__ == "__main__":
    models = {
        "feet": jax_spec.get_model(
            collision_geom_prefixes=jax_spec.FEET_COLLISION_PREFIXES),
        "mpc_plant": jax_spec.get_model(
            collision_geom_prefixes=jax_spec.MPC_COLLISION_PREFIXES),
        "full": jax_spec.get_model(),
    }
    assert spec.MPC_COLLISION_PREFIXES == jax_spec.MPC_COLLISION_PREFIXES
    assert spec.FEET_COLLISION_PREFIXES == jax_spec.FEET_COLLISION_PREFIXES
    for name, model in models.items():
        spec.save_model(model, os.path.join(spec.ASSETS_DIR, name + ".npz"))
