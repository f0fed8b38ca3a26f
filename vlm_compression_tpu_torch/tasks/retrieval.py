"""Image-text retrieval, Flickr30k and COCO (port of
``vlm_compression_tpu/tasks/retrieval.py``).

``evaluation`` tokenizes every caption of the eval set (padded to the
set's longest, clipped at 35 tokens), scores every image against every
caption with the stage-1 Q-Former (``compute_sim_matrix``: the ITC ranking,
then the ITM rerank of the top ``k_test`` candidates of each row) and
returns the score matrices with the dataset's ground-truth maps;
``after_evaluation`` reports R@1/5/10 both ways (``itm_eval``) and appends
them to ``result_dir/../evaluate.txt``.

The stage-1 ``Blip2Qformer`` (archs ``blip2``, ``blip2_feature_extractor``,
``blip2_image_text_matching``) is the one model it scores.  The legacy
zoo's retrieval models are not ported (ROADMAP queue 1, item 11); the
InstructBLIP compositions have no retrieval head, in the JAX package
either.
"""

from __future__ import annotations

import json
import logging
import os

import torch

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets.tokenization import (
    batch_encode,
    load_tokenizer,
)
from vlm_compression_tpu_torch.evaluation.retrieval_metrics import itm_eval
from vlm_compression_tpu_torch.models.blip2_qformer import (
    Blip2Qformer,
    compute_sim_matrix,
)
from vlm_compression_tpu_torch.tasks.base import BaseTask


@registry.register_task("retrieval")
@registry.register_task("ret_flickr_eval")
@registry.register_task("ret_coco_eval")
class RetrievalTask(BaseTask):
    def __init__(self, k_test: int = 0, tokenizer=None,
                 max_txt_len: int = 35):
        super().__init__()
        self.k_test = k_test
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len

    @classmethod
    def setup_task(cls, cfg=None, **kw):
        """``cfg``: a mapping shaped like an eval yaml (its ``run``
        section gives ``k_test``); ``kw`` (the tokenizer) goes to the
        constructor."""
        run = (cfg or {}).get("run") or {}
        return cls(k_test=int(run.get("k_test", 0)), **kw)

    def evaluation(self, model, data_loader, **kw):
        """``data_loader`` yields batches with an ``image`` entry and
        carries the dataset (``text``, ``txt2img``, ``img2txt``) as
        ``.dataset`` (or ``._loader.dataset``).  With no tokenizer, the
        offline ``SimpleTokenizer`` over the Q-Former's vocabulary."""
        ds = getattr(data_loader, "dataset", None)
        if ds is None:
            ds = data_loader._loader.dataset
        if not isinstance(model, Blip2Qformer):
            raise NotImplementedError(
                f"retrieval scores the stage-1 Blip2Qformer only, not "
                f"{type(model).__name__}: the legacy zoo's retrieval models "
                f"are not ported (ROADMAP queue 1, item 11), and the "
                f"InstructBLIP compositions have no retrieval head (in the "
                f"JAX package either)")
        tokenizer = self.tokenizer or load_tokenizer(
            vocab_size=model.cfg.qformer.vocab_size)
        text_ids, text_mask = batch_encode(tokenizer, ds.text,
                                           self.max_txt_len)
        image_batches = (torch.as_tensor(b["image"], dtype=torch.float32)
                         for b in data_loader)
        score_i2t, score_t2i = compute_sim_matrix(
            model, image_batches, text_ids, text_mask, k_test=self.k_test)
        return {"score_i2t": score_i2t, "score_t2i": score_t2i,
                "txt2img": ds.txt2img, "img2txt": ds.img2txt}

    def after_evaluation(self, val_result, split_name="test", epoch="eval",
                         result_dir="result", **kw):
        metrics = itm_eval(val_result["score_i2t"], val_result["score_t2i"],
                           val_result["txt2img"], val_result["img2txt"])
        logging.info("%s retrieval: %s", split_name, metrics)
        os.makedirs(result_dir, exist_ok=True)
        with open(os.path.join(result_dir, "..", "evaluate.txt"), "a") as fh:
            fh.write(json.dumps({split_name: metrics}) + "\n")
        return metrics
