"""Dataset item classes (port of ``vlm_compression_tpu/datasets/items.py``):
samples are dicts with ``image`` (float32 (H, W, 3)), text fields and ids
(``image_id`` for captioning, ``question_id`` for VQA, ``instance_id``
everywhere, for de-duplication when results are saved).

Annotations are JSON lists of dicts (LAVIS format):
  caption:   {"image": rel_path, "caption": str | [str], "image_id": ...}
  vqa:       {"image": rel_path, "question": str, "question_id": ...,
              "answer": [str] | str}
  retrieval: {"image": rel_path, "caption": [str]}

An image file ending in ``.npy`` is read with ``numpy.load`` (a uint8
(H, W, 3) array: the form the card's machine reads, having no Pillow);
any other file is decoded with Pillow, imported where it is read.  The
text (C4), classification, NLVR, entailment, video and dialogue items and
the LAION stream are not ported yet (ROADMAP queue 1, items 6, 11 and
4b).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


def _load_ann(paths) -> List[dict]:
    if isinstance(paths, str):
        paths = [paths]
    out = []
    for p in paths:
        with open(p) as f:
            data = json.load(f)
        out.extend(data if isinstance(data, list) else data["annotations"])
    return out


def load_image(path: str) -> np.ndarray:
    """uint8 (H, W, 3): ``.npy`` through numpy, anything else decoded by
    Pillow and converted to RGB."""
    if path.endswith(".npy"):
        return np.load(path)
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


class BaseItemDataset:
    def __init__(self, vis_processor, text_processor, vis_root: str,
                 ann_paths, max_samples: Optional[int] = None):
        self.vis_processor = vis_processor
        self.text_processor = text_processor
        self.vis_root = vis_root
        self.annotation = _load_ann(ann_paths)
        if max_samples is not None:
            self.annotation = self.annotation[:max_samples]
        for i, ann in enumerate(self.annotation):
            ann.setdefault("instance_id", i)

    def __len__(self):
        return len(self.annotation)

    def _image(self, ann) -> np.ndarray:
        return self.vis_processor(
            load_image(os.path.join(self.vis_root, ann["image"])))

    def collater(self, samples: List[Dict[str, Any]]) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k in samples[0]:
            vals = [s[k] for s in samples]
            if isinstance(vals[0], np.ndarray):
                out[k] = np.stack(vals)
            else:
                out[k] = vals
        return out


class CaptionDataset(BaseItemDataset):
    """train split: one (image, caption) pair per annotation."""

    def __getitem__(self, i):
        ann = self.annotation[i]
        cap = ann["caption"]
        cap = cap[0] if isinstance(cap, list) else cap
        return {
            "image": self._image(ann),
            "text_input": self.text_processor(cap),
            "text_output": self.text_processor(cap),
            "image_id": ann.get("image_id", ann["instance_id"]),
            "instance_id": ann["instance_id"],
        }


class CaptionEvalDataset(BaseItemDataset):
    def __getitem__(self, i):
        ann = self.annotation[i]
        return {
            "image": self._image(ann),
            "image_id": ann.get("image_id", ann["instance_id"]),
            "instance_id": ann["instance_id"],
        }


class VQADataset(BaseItemDataset):
    """train: majority answer; samples carry the full answer list too."""

    def __getitem__(self, i):
        ann = self.annotation[i]
        answers = ann.get("answer", ann.get("answers", []))
        if isinstance(answers, str):
            answers = [answers]
        best = max(set(answers), key=answers.count) if answers else ""
        return {
            "image": self._image(ann),
            "text_input": self.text_processor(ann["question"]),
            "text_output": best,
            "answers": answers,
            "question_id": ann.get("question_id", ann["instance_id"]),
            "instance_id": ann["instance_id"],
        }


class VQAEvalDataset(VQADataset):
    pass


class GQADataset(VQADataset):
    pass


class RetrievalDataset(BaseItemDataset):
    """Flickr30k-style: parallel image and caption lists for the
    similarity matrix of ``tasks/retrieval.py``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.text: List[str] = []
        self.image_paths: List[str] = []
        self.txt2img: List[int] = []
        self.img2txt: Dict[int, List[int]] = {}
        for img_i, ann in enumerate(self.annotation):
            self.image_paths.append(ann.get("image", ann.get("video")))
            self.img2txt[img_i] = []
            caps = ann["caption"]
            caps = caps if isinstance(caps, list) else [caps]
            for c in caps:
                self.img2txt[img_i].append(len(self.text))
                self.text.append(self.text_processor(c))
                self.txt2img.append(img_i)

    def __getitem__(self, i):
        ann = self.annotation[i]
        return {
            "image": self._image(ann),
            "index": i,
            "instance_id": ann["instance_id"],
        }


class PrefixCaptionDataset(CaptionDataset):
    """CC3M / CC12M / SBU prefix-LM pretraining data — the RESSA
    calibration and retrain corpus.  The sample schema of
    ``CaptionDataset``; the task decides how the text is split."""
