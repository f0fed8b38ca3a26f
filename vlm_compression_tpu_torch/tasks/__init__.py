"""Tasks of the port (counterparts of ``vlm_compression_tpu.tasks``): RESSA
retraining, stage-2 image-text pretraining, the VQA / OK-VQA / GQA
evaluation, COCO / NoCaps captioning, Flickr30k / COCO / MSRVTT retrieval,
C4 language modeling, AVSD dialogue and the VQA / GQA reading
comprehension.
Importing the package registers them; ``setup_task`` builds the one a run
config's ``run.task`` names."""

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.tasks import (  # noqa: F401
    captioning,
    classification,
    dialogue_rc,
    pretrain,
    retrain,
    retrieval,
    vqa,
)


def setup_task(cfg, **kw):
    """The task ``run.task`` names.  ``cfg``: a ``common.config.Config`` or
    a mapping shaped like a yaml (its ``run`` and ``model`` sections);
    ``kw`` (tokenizers) goes to the task's constructor."""
    tree = getattr(cfg, "config", cfg)
    name = (tree.get("run") or {}).get("task")
    return registry.get_task_class(name).setup_task(cfg=tree, **kw)
