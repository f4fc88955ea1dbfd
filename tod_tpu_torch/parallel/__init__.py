"""Multi-device serving and training (counterpart of the JAX package's
``parallel``): the ``(dp, tp)`` mesh, the sharding rules and the train step
over a mesh, data-parallel batch serving (``parallel.serving``), the
two-stage pipeline and the spatial split."""

from tod_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from tod_tpu_torch.parallel.sharding import (  # noqa: F401
    batch_sharding,
    param_sharding_tree,
    shard_chunk_step,
    shard_inference,
    shard_train_step,
    state_sharding_tree,
)
from tod_tpu_torch.parallel.spatial import spatial_sharded_forward  # noqa: F401
from tod_tpu_torch.parallel.pipeline import TwoStagePipeline  # noqa: F401
