"""Multi-device parallelism over ``torch.distributed``: device meshes,
sharded MPC, the horizon pipeline.

Counterpart of ``quadruped_gym_tpu/parallel``. JAX's SPMD program over a
``jax.sharding.Mesh`` becomes one process per card, each a rank of a
``torch.distributed`` group (NCCL on the cards, gloo on the CPU), with
the mesh axes as ``DeviceMesh`` dimensions. The MPC sample axis and the
RL env batch spread over the ranks, and the only traffic between them is
a few small all-reduces.
"""

from . import multihost  # noqa: F401
from .mesh import (  # noqa: F401
    DATA_AXIS,
    SAMPLE_AXIS,
    make_mesh,
    replicated,
    sharded_on,
)
from .pipeline import (  # noqa: F401
    STAGE_AXIS,
    pipelined_mppi_plan,
    pipelined_rollout_cost,
)
from .sharded_mpc import (  # noqa: F401
    sharded_batch_mppi_plan,
    sharded_mppi_plan,
    sharded_rollout_costs,
)
