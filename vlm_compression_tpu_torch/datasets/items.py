"""Dataset item classes (port of ``vlm_compression_tpu/datasets/items.py``):
samples are dicts with ``image`` (float32 (H, W, 3)), text fields and ids
(``image_id`` for captioning, ``question_id`` for VQA, ``instance_id``
everywhere, for de-duplication when results are saved).

Annotations are JSON lists of dicts (LAVIS format):
  caption:   {"image": rel_path, "caption": str | [str], "image_id": ...}
  vqa:       {"image": rel_path, "question": str, "question_id": ...,
              "answer": [str] | str}
  retrieval: {"image": rel_path, "caption": [str]}
  text:      {"text": str}  (C4; no image)

An image file ending in ``.npy`` is read with ``numpy.load`` (a uint8
(H, W, 3) array: the form the card's machine reads, having no Pillow);
any other file is decoded with Pillow, imported where it is read.  The
LAION stream (``LaionDataset``) reads local webdataset tar shards the same
way, member by member.  The classification, NLVR, entailment, video and
dialogue items are not ported yet (ROADMAP queue 1, item 11).
"""

from __future__ import annotations

import io
import json
import os
import re
import tarfile
import warnings
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


def load_image(path) -> np.ndarray:
    """uint8 (H, W, 3) from a path or a file object of a tar member:
    ``.npy`` through numpy, anything else decoded by Pillow and converted
    to RGB."""
    name = path if isinstance(path, str) else getattr(path, "name", "")
    if name.endswith(".npy"):
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


class TextDataset(BaseItemDataset):
    """Text-only corpus (C4) for the language-modeling task: annotations
    carry ``text`` (or ``text_input``); there are no images."""

    def _image(self, ann):
        raise RuntimeError("a text-only dataset has no images")

    def __getitem__(self, i):
        ann = self.annotation[i]
        txt = ann.get("text", ann.get("text_input", ""))
        return {"text_input": self.text_processor(txt),
                "instance_id": ann["instance_id"]}


def expand_braces(pattern: str) -> List[str]:
    """Expand every webdataset-style numeric brace range
    (``{00000..01743}``, zero-padded to the low bound's width); several
    ranges expand as a cross product."""
    m = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    if m is None:
        return [pattern]
    lo, hi = m.group(1), m.group(2)
    heads = [pattern[: m.start()] + str(i).zfill(len(lo))
             for i in range(int(lo), int(hi) + 1)]
    return [h + tail for h in heads
            for tail in expand_braces(pattern[m.end():])]


class LaionDataset:
    """Streaming (image, caption) pairs from local webdataset tar shards
    (``location``: a brace pattern of ``.tar`` paths, or a list of them),
    in the sample schema of ``CaptionDataset``.  A sample is the run of
    members sharing one key: the first of ``.npy`` (numpy), ``.jpg``,
    ``.jpeg``, ``.png``, ``.webp`` (Pillow) is its image; ``.json``'s
    ``caption``, else ``.txt``, its caption; a key with no image is
    skipped.  Shards are split over processes by
    ``process_index::process_count``; a process stops after
    ``max_samples``.  No length: it batches by draining
    (``loaders.DataLoader``)."""

    IMAGE_EXTS = (".npy", ".jpg", ".jpeg", ".png", ".webp")

    def __init__(self, vis_processor, text_processor, location,
                 process_index: int = 0, process_count: int = 1,
                 max_samples: Optional[int] = None):
        self.vis_processor = vis_processor
        self.text_processor = text_processor
        pats = [location] if isinstance(location, str) else list(location)
        shards: List[str] = []
        for p in pats:
            shards.extend(expand_braces(p))
        if shards and not any(os.path.exists(s) for s in shards):
            raise FileNotFoundError(
                f"no laion shard exists under {pats} "
                f"({len(shards)} candidates, first: {shards[0]})")
        self.shards = shards[process_index::process_count]
        self.max_samples = max_samples
        self.collater = BaseItemDataset.collater.__get__(self)

    def _decode(self, key: str, blobs: Dict[str, bytes]
                ) -> Optional[Dict[str, Any]]:
        ext = next((e for e in self.IMAGE_EXTS if e in blobs), None)
        if ext is None:
            return None
        caption = ""
        if ".json" in blobs:
            try:
                caption = json.loads(blobs[".json"].decode()).get(
                    "caption", "")
            except (ValueError, AttributeError):
                caption = ""
        elif ".txt" in blobs:
            caption = blobs[".txt"].decode("utf-8", "replace")
        f = io.BytesIO(blobs[ext])
        f.name = key + ext
        return {"image": self.vis_processor(load_image(f)),
                "text_input": self.text_processor(caption),
                "text_output": self.text_processor(caption),
                "image_id": key, "instance_id": key}

    def _samples(self, tf: tarfile.TarFile):
        key, blobs = None, {}
        for member in tf:
            if not member.isfile():
                continue
            k, ext = os.path.splitext(os.path.basename(member.name))
            if key is not None and k != key:
                yield self._decode(key, blobs)
                blobs = {}
            key = k
            blobs[ext.lower()] = tf.extractfile(member).read()
        if key is not None:
            yield self._decode(key, blobs)

    def __iter__(self):
        yielded = 0
        for shard in self.shards:
            if not os.path.exists(shard):
                warnings.warn(f"laion shard missing, skipping: {shard}")
                continue
            with tarfile.open(shard) as tf:
                for s in self._samples(tf):
                    if s is None:
                        continue
                    yield s
                    yielded += 1
                    if self.max_samples is not None and \
                            yielded >= self.max_samples:
                        return
