from vlm_compression_tpu_torch.compression.pruners.base import (  # noqa: F401
    BasePruner,
    DictSparsity,
    LayerWisePrunerBase,
    UniformSparsity,
    convert_spec_to_list,
)
from vlm_compression_tpu_torch.compression.pruners import towers  # noqa: F401
from vlm_compression_tpu_torch.compression.pruners import (  # noqa: F401
    global_pruner,
)
from vlm_compression_tpu_torch.compression.pruners.towers import (  # noqa: F401
    BlipT5WandaPruner,
)
