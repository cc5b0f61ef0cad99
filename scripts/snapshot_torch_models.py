"""Write the PyTorch port's model snapshots from the JAX package's models.

    python scripts/snapshot_torch_models.py

Needs MuJoCo (the JAX package compiles the MJCF with it). Writes
``quadruped_gym_tpu_torch/models/assets/{planning,fast_plant,mpc_plant,full,
fast_plant_nsec32}.npz``, which the port loads in place of the MJCF build
(bit-identical files when nothing changed). ``fast_plant_nsec32`` is the
fast plant with its shin and ankle-servo hulls decimated to 32 support
directions (``get_fast_plant_model(n_secondary=32)``), the third case of
``scripts/full_plant_budget_study.py``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quadruped_gym_tpu.models import spec as jax_spec  # noqa: E402
from quadruped_gym_tpu_torch.models import spec  # noqa: E402

if __name__ == "__main__":
    models = {
        "planning": jax_spec.get_planning_model(),
        "fast_plant": jax_spec.get_fast_plant_model(),
        "mpc_plant": jax_spec.get_model(
            collision_geom_prefixes=jax_spec.MPC_COLLISION_PREFIXES),
        "full": jax_spec.get_model(),
        "fast_plant_nsec32": jax_spec.get_fast_plant_model(n_secondary=32),
    }
    assert spec.MPC_COLLISION_PREFIXES == jax_spec.MPC_COLLISION_PREFIXES
    assert spec.FEET_COLLISION_PREFIXES == jax_spec.FEET_COLLISION_PREFIXES
    for name, model in models.items():
        spec.save_model(model, os.path.join(spec.ASSETS_DIR, name + ".npz"))
