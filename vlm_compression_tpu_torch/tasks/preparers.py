"""Batch preparers: dataset sample dicts → the model's keyword arrays
(port of ``vlm_compression_tpu/tasks/preparers.py``).

The retrain's collation of ``text_input`` / ``text_output`` samples, on
the host: the arrays come back as numpy, as in the JAX package, and the
caller moves the batch to its device.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from vlm_compression_tpu_torch.datasets.tokenization import (
    batch_encode,
    batch_labels,
    pack_qa,
)


def make_t5_batch_preparer(tokenizer, qformer_tokenizer=None,
                           max_txt_len: int = 128,
                           max_output_len: int = 256,
                           prompt: str = "") -> Callable:
    """InstructBLIP-T5: the encoder text, the Q-Former instruction (the
    same text) and the T5 labels (-100 on the pads)."""
    qtok = qformer_tokenizer or tokenizer

    def prepare(samples: Dict) -> Dict[str, np.ndarray]:
        text_in = [prompt + t for t in samples["text_input"]]
        text_out = samples.get("text_output", samples["text_input"])
        input_ids, attn = batch_encode(tokenizer, text_in, max_txt_len)
        labels = batch_labels(tokenizer, text_out, max_output_len)
        q_ids, q_mask = batch_encode(qtok, text_in, max_txt_len)
        return {
            "image": np.asarray(samples["image"], np.float32),
            "input_ids": input_ids, "attention_mask": attn,
            "labels": labels,
            "qformer_input_ids": q_ids, "qformer_attention_mask": q_mask,
        }

    return prepare


def make_vicuna_batch_preparer(tokenizer, qformer_tokenizer=None,
                               max_txt_len: int = 128,
                               max_output_len: int = 256,
                               prompt: str = "") -> Callable:
    """InstructBLIP-Vicuna: prompt ⊕ answer packed and right-padded
    (``pack_qa``: BOS first, EOS after the answer), labels -100 over the
    prompt and the pads; the Q-Former takes the prompt."""
    qtok = qformer_tokenizer or tokenizer

    def prepare(samples: Dict) -> Dict[str, np.ndarray]:
        prompts = [prompt + t for t in samples["text_input"]]
        answers = list(samples.get("text_output", samples["text_input"]))
        ids, mask, labels = pack_qa(tokenizer, prompts, answers,
                                    max_txt_len, max_output_len)
        q_ids, q_mask = batch_encode(qtok, prompts, max_txt_len)
        return {
            "image": np.asarray(samples["image"], np.float32),
            "text_input_ids": ids, "text_attention_mask": mask,
            "labels": labels,
            "qformer_input_ids": q_ids, "qformer_attention_mask": q_mask,
        }

    return prepare
