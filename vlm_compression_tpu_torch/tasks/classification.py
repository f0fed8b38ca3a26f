"""The language-modeling eval task: the perplexity of a composition's
language tower over raw text, C4 in the reference (port of
``LanguageModelingTask`` in ``vlm_compression_tpu/tasks/classification.py``;
its ``MultimodalClassificationTask`` waits with the legacy zoo, ROADMAP
queue 1, item 11).

Each text is encoded with BOS and EOS (``max_len`` tokens at most) and the
labels are the ids, -100 off the mask.  A model with an ``llm_model``
(InstructBLIP-Vicuna's LLaMA) scores them causally; any other runs its
``t5_model`` as a seq2seq denoiser (the ids in, the ids as labels).
``after_evaluation`` weighs each batch's mean loss by its tokens:
``ppl = exp(min(avg, 20))``, ``agg_metrics = −ppl``.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List

import numpy as np
import torch

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets.tokenization import batch_encode
from vlm_compression_tpu_torch.tasks.base import BaseTask


@registry.register_task("language_modeling")
class LanguageModelingTask(BaseTask):
    """Perplexity of the language tower over raw text."""

    def __init__(self, tokenizer=None, max_len: int = 128):
        super().__init__()
        self.tokenizer = tokenizer
        self.max_len = max_len

    @classmethod
    def setup_task(cls, cfg=None, **kw):
        """No run setting is read, as in the JAX package; ``kw`` (the
        tokenizer) goes to the constructor."""
        return cls(**{k: v for k, v in kw.items() if k == "tokenizer"})

    @torch.no_grad()
    def valid_step(self, model, samples) -> List[Dict]:
        ids, mask = batch_encode(self.tokenizer, samples["text_input"],
                                 self.max_len, add_bos=True, add_eos=True)
        labels = np.where(mask.astype(bool), ids, -100)
        lm = (model.llm_model if hasattr(model, "llm_model")
              else model.t5_model)
        dev = next(lm.parameters()).device
        out = lm(*(torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                   for a in (ids, mask)),
                 labels=torch.from_numpy(labels.astype(np.int32)).to(dev))
        return [{"loss": float(out["loss"]), "n_tokens": int(mask.sum())}]

    def after_evaluation(self, val_result, split_name="test", **kw):
        tot = sum(r["n_tokens"] for r in val_result)
        avg = (sum(r["loss"] * r["n_tokens"] for r in val_result)
               / max(tot, 1))
        ppl = float(math.exp(min(avg, 20)))
        metrics = {"agg_metrics": -ppl, "ppl": ppl, "loss": avg}
        logging.info("%s perplexity: %.3f", split_name, ppl)
        return metrics
