"""Tasks of the port (counterparts of ``vlm_compression_tpu.tasks``): RESSA
retraining and the VQA / OK-VQA / GQA evaluation.  Importing the package
registers them."""

from vlm_compression_tpu_torch.tasks import retrain, vqa  # noqa: F401
