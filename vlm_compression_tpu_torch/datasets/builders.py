"""Dataset builders — registry entries binding a dataset config to item
datasets (port of ``vlm_compression_tpu/datasets/builders.py``).

Each builder resolves its processors from the config, builds the train /
val / test item datasets from annotation paths and an image root, and cuts
the train split at ``max_train_samples``.

Config schema (a dict or ``ConfigNode``):
  build_info:
    annotations: {train: [paths], val: [...], test: [...]}
    images: {storage: vis_root}
  vis_processor: {train: {name, ...}, eval: {name, ...}}
  text_processor: {train: {name, ...}, eval: {name, ...}}

Every name of the JAX package is registered and builds its item
datasets.
"""

from __future__ import annotations

from typing import Dict, Optional

from vlm_compression_tpu_torch.common import dist
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets import items as I
from vlm_compression_tpu_torch.datasets.processors import load_processor


def _get(cfg, key, default=None):
    if cfg is None:
        return default
    if hasattr(cfg, "get"):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


class BaseDatasetBuilder:
    train_dataset_cls = I.CaptionDataset
    eval_dataset_cls = I.CaptionEvalDataset

    def __init__(self, cfg=None):
        self.config = cfg or {}

    def _processor(self, kind: str, split: str):
        pcfg = _get(self.config, f"{kind}_processor", {}) or {}
        scfg = _get(pcfg, split) or _get(pcfg, "eval") or {}
        name = _get(scfg, "name")
        if name is None:
            name = ("blip2_image_train" if kind == "vis" and split == "train"
                    else "blip_image_eval" if kind == "vis"
                    else "blip_caption")
        return load_processor(name, scfg)

    def build_datasets(self, max_train_samples: Optional[int] = None
                       ) -> Dict[str, object]:
        info = _get(self.config, "build_info", {}) or {}
        anns = _get(info, "annotations", {}) or {}
        vis_root = _get(_get(info, "images", {}) or {}, "storage", "")
        out = {}
        for split in ("train", "val", "test"):
            paths = _get(anns, split)
            if not paths:
                continue
            cls = (self.train_dataset_cls if split == "train"
                   else self.eval_dataset_cls)
            out[split] = cls(
                vis_processor=self._processor("vis", split),
                text_processor=self._processor("text", split),
                vis_root=vis_root, ann_paths=paths,
                max_samples=max_train_samples if split == "train" else None)
        return out


def _register(name, train_cls, eval_cls):
    cls = type(f"{name}_builder", (BaseDatasetBuilder,),
               {"train_dataset_cls": train_cls, "eval_dataset_cls": eval_cls})
    registry.register_builder(name)(cls)
    return cls


# captioning
COCOCapBuilder = _register("coco_caption", I.CaptionDataset,
                           I.CaptionEvalDataset)
NoCapsBuilder = _register("nocaps", I.CaptionDataset, I.CaptionEvalDataset)

# VQA
COCOVQABuilder = _register("coco_vqa", I.VQADataset, I.VQAEvalDataset)
OKVQABuilder = _register("ok_vqa", I.VQADataset, I.VQAEvalDataset)
AOKVQABuilder = _register("aok_vqa", I.VQADataset, I.VQAEvalDataset)
GQABuilder = _register("gqa", I.GQADataset, I.GQADataset)
VGVQABuilder = _register("vg_vqa", I.VQADataset, I.VQAEvalDataset)

# retrieval
FlickrRetBuilder = _register("flickr30k", I.RetrievalDataset,
                             I.RetrievalDataset)
COCORetBuilder = _register("coco_retrieval", I.RetrievalDataset,
                           I.RetrievalDataset)

# prefix-LM pretraining corpora — the RESSA calibration and retrain data;
# the JAX package's short names and the reference's registry names
for _n in ("cc3m_prefix", "cc12m_prefix", "sbu_prefix", "vg_prefix",
           "coco_prefix", "conceptual_caption_3m", "conceptual_caption_12m",
           "sbu_caption", "vg_caption", "coco_caption_pretrain",
           "prefix_conceptual_caption_3m", "prefix_conceptual_caption_12m",
           "prefix_sbu_caption", "prefix_vg_caption", "prefix_coco_caption",
           "instruct_cc3m_caption", "instruct_coco_caption",
           "instruct_vg_caption"):
    _register(_n, I.PrefixCaptionDataset, I.CaptionEvalDataset)


@registry.register_builder("laion2B_multi")
class Laion2BMultiBuilder(BaseDatasetBuilder):
    """The LAION webdataset stream: train only; ``build_info.storage`` is a
    brace pattern of local ``.tar`` shards.  ``max_train_samples`` is the
    budget of the whole job, split over the processes."""

    train_dataset_cls = I.LaionDataset

    def build_datasets(self, max_train_samples: Optional[int] = None):
        info = _get(self.config, "build_info", {}) or {}
        world = dist.get_world_size()
        per_process = (None if max_train_samples is None
                       else -(-max_train_samples // world))
        return {"train": I.LaionDataset(
            vis_processor=self._processor("vis", "train"),
            text_processor=self._processor("text", "train"),
            location=_get(info, "storage", ""),
            process_index=dist.get_rank(), process_count=world,
            max_samples=per_process)}


def load_builder(name: str, cfg=None) -> BaseDatasetBuilder:
    return registry.get_builder_class(name)(cfg)


# the language-modeling corpus and the classification folders
C4Builder = _register("c4", I.TextDataset, I.TextDataset)
ImageNetBuilder = _register("imagenet", I.ClassificationDataset,
                            I.ClassificationDataset)
CIFAR100Builder = _register("cifar100", I.ClassificationDataset,
                            I.ClassificationDataset)

# classification and entailment pairs
NLVRBuilder = _register("nlvr", I.NLVRDataset, I.NLVRDataset)
SNLIVEBuilder = _register("snli_ve", I.VisualEntailmentDataset,
                          I.VisualEntailmentDataset)

# the video datasets: each item a (t, h, w, c) frame stack, batched into
# the 5-dim (b, t, h, w, c) video input; retrieval's eval split exposes the
# parallel lists of the ALPRO similarity matrix under the ``video`` key
for _n in ("msrvtt_caption", "msvd_caption", "vatex_caption"):
    _register(_n, I.VideoCaptionDataset, I.VideoCaptionEvalDataset)
for _n in ("msrvtt_retrieval", "didemo_retrieval"):
    _register(_n, I.VideoCaptionDataset, I.VideoRetrievalDataset)
for _n in ("msrvtt_qa", "msvd_qa"):
    _register(_n, I.VideoQADataset, I.VideoQAEvalDataset)
AVSDBuilder = _register("avsd_dialogue", I.VideoDialogueDataset,
                        I.VideoDialogueDataset)
