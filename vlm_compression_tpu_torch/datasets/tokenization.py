"""Tokenizer wrappers and batch collation into model-ready id arrays (port
of ``vlm_compression_tpu/datasets/tokenization.py``).

The models consume ids, so tokenization happens in the collator, on the
host.  An HF tokenizer loads from a local path only (``transformers`` is
imported then, and its absence raises); with no path, ``SimpleTokenizer``
— a deterministic whitespace + md5 vocabulary, the same ids as the JAX
package's — keeps the pipeline runnable offline and in tests.

``pack_qa`` is the decoder-only packing (prompt then answer, no pad gap,
labels -100 over the prompt and the pads).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np


class SimpleTokenizer:
    """Token id = a stable hash of the word into the vocabulary; ids 0..3
    reserved: pad 0, eos 1, bos 2, unk 3."""

    def __init__(self, vocab_size: int = 32000, pad_token_id: int = 0,
                 eos_token_id: int = 1, bos_token_id: int = 2):
        self.vocab_size = vocab_size
        self.pad_token_id = pad_token_id
        self.eos_token_id = eos_token_id
        self.bos_token_id = bos_token_id

    def _tok(self, w: str) -> int:
        h = int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
        return 4 + h % (self.vocab_size - 4)

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = [self._tok(w) for w in text.split()]
        if add_bos:
            ids = [self.bos_token_id] + ids
        if add_eos:
            ids = ids + [self.eos_token_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"<{i}>" for i in ids
                        if i not in (self.pad_token_id, self.eos_token_id,
                                     self.bos_token_id))


def load_tokenizer(name_or_path: Optional[str] = None, **kw):
    """An HF tokenizer from a local snapshot path (raises when
    ``transformers`` is missing), else ``SimpleTokenizer``."""
    if name_or_path:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(name_or_path,
                                             local_files_only=True, **kw)
    return SimpleTokenizer(**kw)


def _enc(tokenizer, text, max_len, add_bos=False, add_eos=False):
    if isinstance(tokenizer, SimpleTokenizer):
        ids = tokenizer.encode(text, add_bos=add_bos, add_eos=add_eos)
    else:
        ids = tokenizer.encode(text, add_special_tokens=False)
        if add_bos and tokenizer.bos_token_id is not None:
            ids = [tokenizer.bos_token_id] + ids
        if add_eos and tokenizer.eos_token_id is not None:
            ids = ids + [tokenizer.eos_token_id]
    return ids[:max_len]


def batch_encode(tokenizer, texts: Sequence[str], max_len: int,
                 pad_id: Optional[int] = None, left_pad: bool = False,
                 add_bos: bool = False, add_eos: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(ids (b, L), mask (b, L)) int32, right- (or left-) padded to the
    batch's longest text, clipped at max_len."""
    pad_id = pad_id if pad_id is not None else tokenizer.pad_token_id
    encs = [_enc(tokenizer, t, max_len, add_bos, add_eos) for t in texts]
    L = max(1, min(max(map(len, encs), default=1), max_len))
    ids = np.full((len(texts), L), pad_id, np.int32)
    mask = np.zeros((len(texts), L), np.int32)
    for i, e in enumerate(encs):
        e = e[:L]
        if left_pad:
            ids[i, L - len(e):] = e
            mask[i, L - len(e):] = 1
        else:
            ids[i, :len(e)] = e
            mask[i, :len(e)] = 1
    return ids, mask


def batch_labels(tokenizer, texts: Sequence[str], max_len: int,
                 add_eos: bool = True) -> np.ndarray:
    """T5-style labels (b, L) int32, -100 on the pads."""
    encs = [_enc(tokenizer, t, max_len, add_eos=add_eos) for t in texts]
    L = max(1, min(max(map(len, encs), default=1), max_len))
    out = np.full((len(texts), L), -100, np.int32)
    for i, e in enumerate(encs):
        out[i, :min(len(e), L)] = e[:L]
    return out


def pack_qa(tokenizer, prompts: Sequence[str], answers: Sequence[str],
            max_txt_len: int, max_output_len: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decoder-only packing: (text_input_ids, text_attention_mask, labels),
    labels -100 on the prompt tokens and the pads, the answer tokens (with
    EOS) supervised."""
    packed, lbl = [], []
    for p, a in zip(prompts, answers):
        pi = _enc(tokenizer, p, max_txt_len, add_bos=True)
        ai = _enc(tokenizer, a, max_output_len, add_eos=True)
        packed.append(pi + ai)
        lbl.append([-100] * len(pi) + ai)
    L = max(map(len, packed))
    pad = (tokenizer.pad_token_id
           if tokenizer.pad_token_id is not None else 0)
    ids = np.full((len(packed), L), pad, np.int32)
    mask = np.zeros((len(packed), L), np.int32)
    labels = np.full((len(packed), L), -100, np.int32)
    for i, (e, l) in enumerate(zip(packed, lbl)):
        ids[i, :len(e)] = e
        mask[i, :len(e)] = 1
        labels[i, :len(l)] = l
    return ids, mask, labels
