"""Tensor, data and pipeline parallelism of the port (port of
``vlm_compression_tpu/parallel``): the mesh and its sharding rules, the
GPipe engine, and the explicit collectives the JAX package leaves to
GSPMD."""

from vlm_compression_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshConfig,
    make_mesh,
    shard_params,
    param_partition_spec,
)
from vlm_compression_tpu_torch.parallel.pipeline import (  # noqa: F401
    make_pipeline_fn,
    pipeline_apply,
    shard_stages,
    split_stages,
    stack_layer_params,
)
