"""Text processors (port of the text half of
``vlm_compression_tpu/datasets/processors.py``): ``blip_caption`` (prompt +
cleaning + max-words truncation) and ``blip_question`` (lowercase,
punctuation stripped).  The image processors need PIL and come with the
data layer."""

from __future__ import annotations

import re
from typing import Optional


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


class BlipCaptionProcessor:
    def __init__(self, prompt: str = "", max_words: int = 50):
        self.prompt = prompt
        self.max_words = max_words

    def __call__(self, caption: str) -> str:
        return self.prompt + pre_caption(caption, self.max_words)


class BlipQuestionProcessor:
    def __init__(self, max_words: int = 50):
        self.max_words = max_words

    def __call__(self, question: str) -> str:
        return pre_question(question, self.max_words)
