"""Image and text processors (port of
``vlm_compression_tpu/datasets/processors.py``).

Registry names: ``blip_image_eval`` / ``blip2_image_eval`` (bicubic resize
to a square, normalize), ``blip2_image_train`` (random resized crop of
scale 0.5-1 and ratio 3/4-4/3, bicubic resize, horizontal flip at p = 0.5,
normalize), ``clip_image_eval`` (resize the short side, centre crop,
normalize), ``blip_caption`` (prompt + cleaning + max-words truncation)
and ``blip_question`` (lowercase, punctuation stripped); the train
transforms ``blip_image_train`` (``blip2_image_train``'s crop and flip,
then RandAugment(2, 5) over the ten ops of ``_RA_OPS``, each a numpy copy
of its Pillow call in ``datasets/_randaug.py``) and ``clip_image_train``
(the crop at scale 0.9-1); ALPRO's ``alpro_video_eval`` /
``alpro_video_train`` (frames subsampled to ``n_frms``, one crop and flip
for all of them) and AVSD's ``gpt_dialogue`` (token streams) and
``gpt_video_ft`` (feature stacks).

The image processors take uint8 (H, W, 3) arrays (``datasets/items.py``
decodes files into them) and resize with ``datasets/_resample.py``, a
numpy copy of Pillow's bicubic resize: the card's machine has no Pillow.
Outputs are float32 (H, W, 3) arrays normalized with the OpenAI-CLIP
constants, as the JAX package's are.  The train transforms draw their crop, flip
and augmentations from their ``np.random.Generator`` with the JAX
processors' calls, in their order.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Sequence

import numpy as np

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets import _randaug as RA
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


# ---------------------------------------------------------------------------
# RandAugment (the BLIP-1 train transform's op list), on uint8 arrays: each op
# a numpy copy of its Pillow call (``datasets/_randaug.py``)
# ---------------------------------------------------------------------------

_RA_OPS = {
    "Identity": lambda img, v: img,
    "AutoContrast": lambda img, v: RA.autocontrast(img),
    "Equalize": lambda img, v: RA.equalize(img),
    "Brightness": lambda img, v: RA.blend(np.zeros_like(img), img,
                                          1.0 + 0.6 * v),
    "Sharpness": lambda img, v: RA.blend(RA.smooth(img), img, 1.0 + 0.6 * v),
    "ShearX": lambda img, v: RA.affine_nearest(img, (1, 0.3 * v, 0, 0, 1, 0)),
    "ShearY": lambda img, v: RA.affine_nearest(img, (1, 0, 0, 0.3 * v, 1, 0)),
    "TranslateX": lambda img, v: RA.affine_nearest(
        img, (1, 0, 0.2 * v * img.shape[1], 0, 1, 0)),
    "TranslateY": lambda img, v: RA.affine_nearest(
        img, (1, 0, 0, 0, 1, 0.2 * v * img.shape[0])),
    "Rotate": lambda img, v: RA.rotate(img, 30 * v),
}


class RandomAugment:
    """``n`` ops drawn with replacement, each at magnitude ``m``/10 with a
    drawn sign: ``rng.choice(augs, n)``, then one ``rng.choice((-1, 1))``
    an op, as the JAX processor draws them."""

    def __init__(self, n: int = 2, m: int = 5, augs=None, rng=None):
        self.n = n
        self.m = m
        self.augs = list(augs or _RA_OPS)
        self.rng = rng or np.random.default_rng()

    def __call__(self, img: np.ndarray) -> np.ndarray:
        for name in self.rng.choice(self.augs, self.n):
            v = (self.m / 10.0) * self.rng.choice((-1.0, 1.0))
            img = _RA_OPS[name](img, float(v))
        return img


@registry.register_processor("blip_image_train")
class BlipImageTrainProcessor(Blip2ImageTrainProcessor):
    """BLIP-1's train transform: ``blip2_image_train``'s crop and flip,
    then RandAugment(2, 5), then normalize."""

    def __init__(self, image_size: int = 384, min_scale: float = 0.5,
                 max_scale: float = 1.0, rng=None):
        super().__init__(image_size, min_scale, max_scale, rng)
        self.randaug = RandomAugment(2, 5, rng=self.rng)

    def __call__(self, img) -> np.ndarray:
        return _to_float(self.randaug(self.crop_flip(img)))


@registry.register_processor("clip_image_train")
class ClipImageTrainProcessor(Blip2ImageTrainProcessor):
    """The random resized crop at scale 0.9-1.0, flip, normalize."""

    def __init__(self, image_size: int = 224, min_scale: float = 0.9,
                 max_scale: float = 1.0, rng=None):
        super().__init__(image_size, min_scale, max_scale, rng)


# ---------------------------------------------------------------------------
# video and dialogue
# ---------------------------------------------------------------------------


class _AlproVideoBase(BaseProcessor):
    """Video transforms over a (t, h, w, 3) stack or a list of frames:
    frames subsampled to exactly ``n_frms`` by ``linspace(...).round()``
    (a short clip repeats frames), one spatial transform for all of
    them."""

    cfg_keys = ("image_size", "n_frms")

    def __init__(self, image_size: int = 224, n_frms: int = 8, rng=None):
        self.image_size = image_size
        self.n_frms = n_frms
        self.rng = rng or np.random.default_rng()

    def _frames(self, video) -> list:
        if isinstance(video, np.ndarray) and video.dtype != np.uint8:
            video = (np.clip(video, 0, 1) * 255).astype(np.uint8)
        frames = [as_rgb(f) for f in video]
        idx = np.linspace(0, len(frames) - 1, self.n_frms).round() \
            .astype(int)
        return [frames[i] for i in idx]


@registry.register_processor("alpro_video_eval")
class AlproVideoEvalProcessor(_AlproVideoBase):
    def __call__(self, video) -> np.ndarray:
        size = (self.image_size, self.image_size)
        return np.stack([_to_float(resize_bicubic(f, size))
                         for f in self._frames(video)]).astype(np.float32)


@registry.register_processor("alpro_video_train")
class AlproVideoTrainProcessor(_AlproVideoBase):
    """One square crop of the short side at a drawn offset and one drawn
    flip, shared by every frame."""

    def __call__(self, video) -> np.ndarray:
        frames = self._frames(video)
        h, w = frames[0].shape[:2]
        s = min(w, h)
        x = int(self.rng.integers(0, w - s + 1))
        y = int(self.rng.integers(0, h - s + 1))
        flip = self.rng.random() < 0.5
        size = (self.image_size, self.image_size)
        out = []
        for f in frames:
            f = resize_bicubic(f[y:y + s, x:x + s], size)
            out.append(_to_float(f[:, ::-1] if flip else f))
        return np.stack(out).astype(np.float32)


@registry.register_processor("gpt_dialogue")
class GPTDialogueProcessor(BaseProcessor):
    """An AVSD annotation → GPT token streams: [caption ⊕ the last
    ``max_turns`` turns ⊕ the question ⊕ the answer], each segment ended
    by EOS; token-type ids mark the caption and the two speakers; the
    labels keep the answer alone (−1 elsewhere).  The special ids follow
    the tokenizer's vocabulary, in the order <bos> <eos> <speaker1>
    <speaker2> <cap>."""

    cfg_keys = ("max_turns", "use_caption")

    def __init__(self, max_turns: int = 3, use_caption: bool = True,
                 tokenizer=None):
        from vlm_compression_tpu_torch.datasets.tokenization import (
            SimpleTokenizer,
        )

        self.max_turns = max_turns
        self.use_caption = use_caption
        self.tokenizer = tokenizer or SimpleTokenizer(vocab_size=8192)
        base = getattr(self.tokenizer, "vocab_size", 8192)
        (self.bos, self.eos, self.speaker1, self.speaker2,
         self.cap) = range(base, base + 5)

    def _encode(self, text):
        tok = self.tokenizer
        ids = tok.encode(text) if hasattr(tok, "encode") else tok(text)
        if isinstance(ids, dict):
            ids = ids["input_ids"]
        return [int(t) for t in ids]

    def sample_sequence(self, caption, history, answer):
        seqs = [s + [self.eos] for s in [caption] + history + [answer]]
        input_ids = [t for s in seqs for t in s]
        token_type = [self.cap] * len(seqs[0]) + [
            self.speaker2 if i % 2 else self.speaker1
            for i, s in enumerate(seqs[1:]) for _ in s]
        labels = [-1] * sum(len(s) for s in seqs[:-1]) + seqs[-1]
        return {"input_ids": np.asarray(input_ids, np.int32),
                "token_type_ids": np.asarray(token_type, np.int32),
                "labels": np.asarray(labels, np.int32)}

    def __call__(self, ann):
        caption = (self._encode(" ".join(
            [ann.get("caption", ""), ann.get("summary", "")]))
            if self.use_caption else [])
        history = []
        for turn in ann.get("dialog", [])[-self.max_turns:]:
            history.append(self._encode(turn["question"]))
            history.append(self._encode(turn["answer"]))
        history.append(self._encode(ann["question"]))
        return self.sample_sequence(caption, history,
                                    self._encode(ann["answer"]))


@registry.register_processor("gpt_video_ft")
class GPTVideoFeatureProcessor(BaseProcessor):
    """Pre-extracted feature stacks of a clip: ``{ft_root}/{name}/
    {vname}.npy`` for each visual then audio feature, cut to the shortest
    and concatenated along the features, with an all-ones mask."""

    cfg_keys = ("visual_ft", "audio_ft")

    def __init__(self, visual_ft=("i3d_rgb",), audio_ft=("vggish",)):
        self.visual_ft = list(visual_ft)
        self.audio_ft = list(audio_ft)

    def __call__(self, ft_root: str, vname: str) -> dict:
        fts = [np.load(os.path.join(ft_root, name, f"{vname}.npy"))
               .astype(np.float32)
               for name in self.visual_ft + self.audio_ft]
        min_t = min(f.shape[0] for f in fts)
        feat = np.concatenate([f[:min_t] for f in fts], axis=-1)
        return {"video_fts": feat,
                "attention_mask": np.ones((feat.shape[0],), np.int32)}


def load_processor(name: str, cfg=None):
    return registry.get_processor_class(name).from_config(cfg)
