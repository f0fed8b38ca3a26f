"""Command-line entry points of the port (counterpart of
``vlm_compression_tpu.cli``): ``python -m
vlm_compression_tpu_torch.cli.evaluate``."""
