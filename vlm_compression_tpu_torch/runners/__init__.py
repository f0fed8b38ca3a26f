"""Runners of the port (counterpart of ``vlm_compression_tpu.runners``):
``runner_base`` (epochs) and ``runner_iter`` (inner epochs of a fixed
number of iterations), registered by name."""

from vlm_compression_tpu_torch.runners.runner_base import (  # noqa: F401
    RunnerBase,
)
from vlm_compression_tpu_torch.runners.runner_iter import (  # noqa: F401
    RunnerIter,
)
