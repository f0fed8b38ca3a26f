"""Tensor ops of the port: masked matmul, attention, calibration
statistics and mask selection (counterparts of ``vlm_compression_tpu.ops``).
Kernel modules expose a plain ``launches`` counter each."""
