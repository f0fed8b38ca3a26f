"""The multimodal classification and language-modeling eval tasks (port
of ``vlm_compression_tpu/tasks/classification.py``).

``multimodal_classification`` ranks the class names for each sample by
``predict_class_t5`` on InstructBLIP-T5 (the decoder's summed NLL of each
name, the lowest wins) and reports accuracy, with the model-size
accounting when the caller passes ``orig_total_size`` and
``distilled_total_size``.  The reference pairs the task with ``clip``,
``blip_nlvr`` and ``albef_*`` in its project yamls, but those models have
no ``predict_class`` in the JAX package and its task fails on them; the
port raises, naming this, and adds no branch the reference lacks.

``language_modeling``: each text is encoded with BOS and EOS (``max_len``
tokens at most) and the labels are the ids, -100 off the mask.  A model with an ``llm_model``
(InstructBLIP-Vicuna's LLaMA) scores them causally; any other runs its
``t5_model`` as a seq2seq denoiser (the ids in, the ids as labels).
``after_evaluation`` weighs each batch's mean loss by its tokens:
``ppl = exp(min(avg, 20))``, ``agg_metrics = −ppl``.
"""

from __future__ import annotations

import json
import logging
import math
import os
from typing import Dict, List

import numpy as np
import torch

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets.tokenization import (
    batch_encode,
    batch_labels,
)
from vlm_compression_tpu_torch.tasks.base import BaseTask


@registry.register_task("multimodal_classification")
class MultimodalClassificationTask(BaseTask):
    """Rank each sample's class candidates by the decoder's NLL."""

    def __init__(self, tokenizer=None, qformer_tokenizer=None,
                 class_names: List[str] = None, max_len: int = 8):
        super().__init__()
        self.tokenizer = tokenizer
        self.qformer_tokenizer = qformer_tokenizer or tokenizer
        self.class_names = class_names or []
        self.max_len = max_len

    @classmethod
    def setup_task(cls, cfg=None, **kw):
        """No run setting is read, as in the JAX package; ``kw`` (the
        tokenizers, the class names) goes to the constructor."""
        return cls(**kw)

    @torch.no_grad()
    def valid_step(self, model, samples) -> List[Dict]:
        from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
            Blip2T5Instruct,
            predict_class_t5,
        )

        if not isinstance(model, Blip2T5Instruct):
            raise NotImplementedError(
                f"multimodal_classification ranks class names with "
                f"predict_class_t5, which only InstructBLIP-T5 has: "
                f"{type(model).__name__} has no such method, and the JAX "
                f"package's task fails on it too")
        dev = model.device
        cands = batch_labels(self.tokenizer, self.class_names, self.max_len)
        ids, mask = batch_encode(self.tokenizer, samples["text_input"], 64)
        q_ids, q_mask = batch_encode(self.qformer_tokenizer,
                                     samples["text_input"], 64)
        nll = predict_class_t5(
            model, torch.as_tensor(np.asarray(samples["image"], np.float32),
                                   device=dev),
            *(torch.from_numpy(np.asarray(a, np.int32)).to(dev)
              for a in (ids, mask, cands, q_ids, q_mask)))
        pred = torch.argmin(nll, dim=-1).cpu().numpy()
        out = []
        for i, p in enumerate(pred):
            rec = {"instance_id": samples["instance_id"][i],
                   "prediction": self.class_names[int(p)]}
            if "label" in samples:
                rec["label"] = samples["label"][i]
            out.append(rec)
        return out

    def after_evaluation(self, val_result, split_name="test", epoch="eval",
                         result_dir="result", **kw):
        scored = [r for r in val_result if "label" in r]
        acc = (100.0 * sum(r["prediction"] == r["label"] for r in scored)
               / max(len(scored), 1))
        metrics = {"agg_metrics": acc, "acc": acc}
        if "orig_total_size" in kw and "distilled_total_size" in kw:
            metrics["orig_size"] = \
                f"{kw['orig_total_size'] / 10 ** 9:.3f} B"
            metrics["dist_size"] = \
                f"{kw['distilled_total_size'] / 10 ** 9:.3f} B"
        logging.info("%s classification acc: %.2f", split_name, acc)
        os.makedirs(result_dir, exist_ok=True)
        with open(os.path.join(result_dir, "..", "evaluate.txt"), "a") as fh:
            fh.write(json.dumps({split_name: metrics}) + "\n")
        return metrics


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
