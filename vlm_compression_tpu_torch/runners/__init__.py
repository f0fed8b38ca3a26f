"""Runners of the port (counterpart of ``vlm_compression_tpu.runners``)."""

from vlm_compression_tpu_torch.runners.runner_base import (  # noqa: F401
    RunnerBase,
)
