"""Image and text processors (port of
``vlm_compression_tpu/datasets/processors.py``).

Registry names: ``blip_image_eval`` / ``blip2_image_eval`` (bicubic resize
to a square, normalize), ``blip2_image_train`` (random resized crop of
scale 0.5-1 and ratio 3/4-4/3, bicubic resize, horizontal flip at p = 0.5,
normalize), ``clip_image_eval`` (resize the short side, centre crop,
normalize), ``blip_caption`` (prompt + cleaning + max-words truncation)
and ``blip_question`` (lowercase, punctuation stripped).

The image processors take uint8 (H, W, 3) arrays (``datasets/items.py``
decodes files into them) and resize with ``datasets/_resample.py``, a
numpy copy of Pillow's bicubic resize: the card's machine has no Pillow.
Outputs are float32 (H, W, 3) arrays normalized with the OpenAI-CLIP
constants, as the JAX package's are.  ``blip2_image_train`` draws its crop
and flip from its ``np.random.Generator`` with the JAX processor's calls,
in their order.
"""

from __future__ import annotations

import re
from typing import Optional, Sequence

import numpy as np

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets._resample import resize_bicubic

# OpenAI-CLIP normalization used by every BLIP-2 processor
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def as_rgb(img) -> np.ndarray:
    """uint8 (H, W, 3); a grey (H, W) image gets its channel three times,
    as Pillow's conversion to RGB gives it."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"images are uint8 arrays, got {arr.dtype}")
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {arr.shape}")
    return arr


def _to_float(img: np.ndarray) -> np.ndarray:
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - np.asarray(MEAN, np.float32)) / np.asarray(STD, np.float32)


class BaseProcessor:
    cfg_keys: Sequence[str] = ()

    @classmethod
    def from_config(cls, cfg=None):
        cfg = cfg or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        return cls(**{k: get(k) for k in cls.cfg_keys if get(k) is not None})


@registry.register_processor("blip_image_eval")
@registry.register_processor("blip2_image_eval")
class BlipImageEvalProcessor(BaseProcessor):
    cfg_keys = ("image_size",)

    def __init__(self, image_size: int = 224):
        self.image_size = image_size

    def __call__(self, img) -> np.ndarray:
        return _to_float(resize_bicubic(
            as_rgb(img), (self.image_size, self.image_size)))


@registry.register_processor("blip2_image_train")
class Blip2ImageTrainProcessor(BaseProcessor):
    """RandomResizedCrop(scale=(0.5, 1.0)) + horizontal flip + normalize."""

    cfg_keys = ("image_size", "min_scale", "max_scale")

    def __init__(self, image_size: int = 224, min_scale: float = 0.5,
                 max_scale: float = 1.0,
                 rng: Optional[np.random.Generator] = None):
        self.image_size = image_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.rng = rng or np.random.default_rng()

    def crop_flip(self, img) -> np.ndarray:
        img = as_rgb(img)
        h, w = img.shape[:2]
        area = w * h
        for _ in range(10):
            target = area * self.rng.uniform(self.min_scale, self.max_scale)
            ratio = np.exp(self.rng.uniform(np.log(3 / 4), np.log(4 / 3)))
            cw = int(round(np.sqrt(target * ratio)))
            ch = int(round(np.sqrt(target / ratio)))
            if 0 < cw <= w and 0 < ch <= h:
                x = int(self.rng.integers(0, w - cw + 1))
                y = int(self.rng.integers(0, h - ch + 1))
                img = img[y:y + ch, x:x + cw]
                break
        else:  # fallback: centre crop of the short side
            s = min(w, h)
            x, y = (w - s) // 2, (h - s) // 2
            img = img[y:y + s, x:x + s]
        img = resize_bicubic(img, (self.image_size, self.image_size))
        if self.rng.random() < 0.5:
            img = img[:, ::-1]
        return img

    def __call__(self, img) -> np.ndarray:
        return _to_float(self.crop_flip(img))


@registry.register_processor("clip_image_eval")
class ClipImageEvalProcessor(BaseProcessor):
    """Resize the shorter side to ``image_size``, centre crop."""

    cfg_keys = ("image_size",)

    def __init__(self, image_size: int = 224):
        self.image_size = image_size

    def __call__(self, img) -> np.ndarray:
        img = as_rgb(img)
        h, w = img.shape[:2]
        scale = self.image_size / min(w, h)
        size = self.image_size
        img = resize_bicubic(img, (max(size, int(round(w * scale))),
                                   max(size, int(round(h * scale)))))
        h, w = img.shape[:2]
        x = (w - self.image_size) // 2
        y = (h - self.image_size) // 2
        return _to_float(img[y:y + self.image_size, x:x + self.image_size])


def pre_caption(caption: str, max_words: Optional[int] = None) -> str:
    """Strip the punctuation classes, collapse whitespace, keep at most
    ``max_words`` words."""
    caption = re.sub(r"([.!\"()*#:;~])", " ", caption.lower())
    caption = re.sub(r"\s{2,}", " ", caption)
    caption = caption.rstrip("\n").strip(" ")
    if max_words is not None:
        caption = " ".join(caption.split(" ")[:max_words])
    return caption


def pre_question(question: str, max_words: Optional[int] = None) -> str:
    question = re.sub(r"([.!\"()*#:;~])", "", question.lower())
    question = question.rstrip(" ")
    if max_words is not None:
        question = " ".join(question.split(" ")[:max_words])
    return question


@registry.register_processor("blip_caption")
class BlipCaptionProcessor(BaseProcessor):
    cfg_keys = ("prompt", "max_words")

    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + pre_caption(caption, self.max_words)


@registry.register_processor("blip_question")
class BlipQuestionProcessor(BaseProcessor):
    cfg_keys = ("max_words",)

    def __init__(self, max_words: int = 50):
        self.max_words = max_words

    def __call__(self, question: str) -> str:
        return pre_question(question, self.max_words)


def _not_ported(name: str, item: int):
    def raise_(cfg=None):
        raise NotImplementedError(f"processor {name!r} is not ported yet "
                                  f"(ROADMAP queue 1, item {item})")
    return type(name, (BaseProcessor,), {"from_config": staticmethod(raise_)})


# the JAX package's other names: RandAugment's BLIP-1 transform and the
# legacy zoo's (CLIP training, ALPRO video, the AVSD dialogue)
for _name in ("blip_image_train", "clip_image_train", "alpro_video_eval",
              "alpro_video_train", "gpt_dialogue", "gpt_video_ft"):
    registry.register_processor(_name)(_not_ported(_name, 11))


def load_processor(name: str, cfg=None):
    return registry.get_processor_class(name).from_config(cfg)
