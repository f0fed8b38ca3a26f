"""Tasks of the port (counterparts of ``vlm_compression_tpu.tasks``):
RESSA retraining.  Importing the package registers them."""

from vlm_compression_tpu_torch.tasks import retrain  # noqa: F401
