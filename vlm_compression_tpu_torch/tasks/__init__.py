"""Tasks of the port (counterparts of ``vlm_compression_tpu.tasks``): RESSA
retraining, the VQA / OK-VQA / GQA evaluation, COCO / NoCaps captioning
and Flickr30k / COCO retrieval.  Importing the package registers them."""

from vlm_compression_tpu_torch.tasks import (  # noqa: F401
    captioning,
    retrain,
    retrieval,
    vqa,
)
