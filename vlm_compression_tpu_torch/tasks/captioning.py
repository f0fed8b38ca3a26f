"""Captioning task, COCO and NoCaps (port of
``vlm_compression_tpu/tasks/captioning.py``).

``valid_step`` encodes the prompt ("a photo of" by default, 32 tokens) for
InstructBLIP-T5's encoder and its Q-Former, generates with beam search
(``max_len`` new tokens, at least ``min_len``, no repetition penalty) and
decodes each row after its start token, cut at EOS.  ``after_evaluation``
saves the results (a shard per process, merged) and scores them with the
COCO caption metrics (``agg_metrics = CIDEr + BLEU-4``), appending them to
``result_dir/../evaluate.txt``.  The ground-truth captions come from the
eval datasets' annotations (``before_evaluation``) or from ``gts``.

Captioning drives the T5 composition only, as in the JAX package; an
InstructBLIP-Vicuna model raises.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List

import numpy as np
import torch

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets.tokenization import (
    batch_encode,
    load_tokenizer,
)
from vlm_compression_tpu_torch.evaluation.caption_metrics import (
    coco_caption_eval,
)
from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
    Blip2T5Instruct,
    generate_t5,
)
from vlm_compression_tpu_torch.models.generation import GenerationConfig
from vlm_compression_tpu_torch.tasks.base import BaseTask


@registry.register_task("captioning")
class CaptionTask(BaseTask):
    def __init__(self, num_beams: int = 5, max_len: int = 30,
                 min_len: int = 8, prompt: str = "a photo of",
                 tokenizer=None, qformer_tokenizer=None, gts=None):
        super().__init__()
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.prompt = prompt
        self.tokenizer = tokenizer if tokenizer is not None \
            else load_tokenizer()
        self.qformer_tokenizer = qformer_tokenizer or self.tokenizer
        self.gts = gts or {}

    @classmethod
    def setup_task(cls, cfg=None, **kw):
        """``cfg``: a mapping shaped like an eval yaml (its ``run``
        section); ``kw`` (the tokenizers, ``gts``) goes to the
        constructor."""
        run = (cfg or {}).get("run") or {}
        return cls(num_beams=int(run.get("num_beams", 5)),
                   max_len=int(run.get("max_len", 30)),
                   min_len=int(run.get("min_len", 8)),
                   prompt=str(run.get("prompt", "a photo of")), **kw)

    def before_evaluation(self, model, dataset, **kw):
        """Collect the ground-truth captions of the eval datasets'
        annotations (one dataset, or {name: {split: dataset}})."""
        def pull(ds):
            for ann in getattr(ds, "annotation", []):
                caps = ann.get("caption")
                if caps is None:
                    continue
                caps = caps if isinstance(caps, list) else [caps]
                key = ann.get("image_id", ann.get("instance_id"))
                self.gts.setdefault(key, []).extend(caps)

        if isinstance(dataset, dict):
            for by_split in dataset.values():
                for ds in (by_split.values()
                           if isinstance(by_split, dict) else []):
                    pull(ds)
        else:
            pull(dataset)

    def valid_step(self, model, samples) -> List[Dict]:
        """model: an InstructBLIP-T5 (``Blip2T5Instruct``)."""
        if not isinstance(model, Blip2T5Instruct):
            raise NotImplementedError(
                "captioning drives the InstructBLIP-T5 composition only: "
                "the JAX package's CaptionTask asserts that composition, so "
                f"there is no {type(model).__name__} captioning to port")
        b = len(samples["image_id"])
        prompts = [self.prompt] * b
        dev = model.device

        def t(a):
            return torch.from_numpy(np.asarray(a)).to(dev)

        ids, mask = batch_encode(self.tokenizer, prompts, 32)
        q_ids, q_mask = batch_encode(self.qformer_tokenizer, prompts, 32)
        image = torch.as_tensor(samples["image"], dtype=torch.float32,
                                device=dev)
        seqs = generate_t5(
            model, image, t(ids), t(mask), t(q_ids), t(q_mask),
            gen_cfg=GenerationConfig(num_beams=self.num_beams,
                                     max_length=self.max_len + 1,
                                     min_length=self.min_len,
                                     repetition_penalty=1.0))
        tok = self.tokenizer
        caps = []
        for row in seqs.cpu().tolist():
            row = row[1:]
            if tok.eos_token_id in row:
                row = row[:row.index(tok.eos_token_id)]
            caps.append(tok.decode(row).strip())
        return [{"image_id": samples["image_id"][i], "caption": caps[i]}
                for i in range(b)]

    def after_evaluation(self, val_result, split_name="test", epoch="eval",
                         result_dir="result", **kw):
        f = self.save_result(val_result, result_dir,
                             f"{split_name}_caption_result",
                             remove_duplicate="image_id")
        with open(f) as fh:
            results = json.load(fh)
        if not self.gts:
            return {"agg_metrics": 0.0}
        metrics = coco_caption_eval(results, self.gts)
        logging.info("%s caption metrics: %s", split_name, metrics)
        with open(os.path.join(result_dir, "..", "evaluate.txt"), "a") as fh:
            fh.write(json.dumps({split_name: metrics}) + "\n")
        return metrics
