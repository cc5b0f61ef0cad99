"""Write the PyTorch port's model snapshots from the JAX package's models.

    python scripts/snapshot_torch_models.py

Needs MuJoCo (the JAX package compiles the MJCF with it). Writes
``quadruped_gym_tpu_torch/models/assets/{planning,fast_plant}.npz``, which
the port loads in place of the MJCF build.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from quadruped_gym_tpu.models import spec as jax_spec  # noqa: E402
from quadruped_gym_tpu_torch.models import spec  # noqa: E402

if __name__ == "__main__":
    spec.save_model(jax_spec.get_planning_model(),
                    os.path.join(spec.ASSETS_DIR, "planning.npz"))
    spec.save_model(jax_spec.get_fast_plant_model(),
                    os.path.join(spec.ASSETS_DIR, "fast_plant.npz"))
