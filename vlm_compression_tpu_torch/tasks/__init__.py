"""Tasks of the port (counterparts of ``vlm_compression_tpu.tasks``): RESSA
retraining, the VQA / OK-VQA / GQA evaluation and COCO / NoCaps
captioning.  Importing the package registers them."""

from vlm_compression_tpu_torch.tasks import captioning, retrain, vqa  # noqa: F401
