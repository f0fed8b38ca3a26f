"""Image-text retrieval, Flickr30k and COCO (port of
``vlm_compression_tpu/tasks/retrieval.py``).

``evaluation`` tokenizes every caption of the eval set (padded to the
set's longest, clipped at 35 tokens), scores every image against every
caption and returns the score matrices with the dataset's ground-truth
maps; ``after_evaluation`` reports R@1/5/10 both ways (``itm_eval``) and
appends them to ``result_dir/../evaluate.txt``.

The stage-1 ``Blip2Qformer`` (archs ``blip2``, ``blip2_feature_extractor``,
``blip2_image_text_matching``) scores through ``compute_sim_matrix``; the
legacy zoo through ``zoo_sim_matrix``: BLIP-1 and ALBEF rank by ITC and
rerank the top ``k_test`` of each row by ITM, CLIP and EVA-CLIP by ITC
alone; ALPRO ranks videos (each batch's ``video`` entry) by VTC and
reranks by VTM, fusing from the text hidden states as ALBEF does.  The
InstructBLIP compositions have no retrieval head, in the JAX package
either.
"""

from __future__ import annotations

import json
import logging
import os

import numpy as np
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
from vlm_compression_tpu_torch.models.albef import AlbefBase
from vlm_compression_tpu_torch.models.alpro import AlproBase
from vlm_compression_tpu_torch.models.blip1 import ZooBase
from vlm_compression_tpu_torch.models.clip_model import Clip
from vlm_compression_tpu_torch.tasks.base import BaseTask


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _topk_rows(base: np.ndarray, k: int) -> np.ndarray:
    """Each row's k best columns in ``np.argsort(row)[::-1][:k]`` order,
    ties included (the JAX package's host-side pick)."""
    return np.stack([np.argsort(row)[::-1][:k] for row in base])


@torch.no_grad()
def zoo_sim_matrix(model, image_batches, text_ids, text_mask,
                   k_test: int = 0, enc_token_id=None):
    """(score_i2t, score_t2i) of the legacy zoo's retrieval models.

    CLIP / EVA-CLIP: the features' similarity (no ITM head).  BLIP-1 /
    ALBEF: the ITC similarity of the unit-norm projections; with
    ``k_test`` > 0 each row's ``k_test`` ITC-best candidates are reranked:
    the score matrix starts at −100.0 and each picked entry becomes its ITC
    score plus the RAW float32 ``itm_head`` logit of class 1 (not a
    probability).  BLIP-1 fuses from token ids, with ``enc_token_id`` (when
    given) at position 0 for the ITM pass only; ALBEF and ALPRO (over
    video batches, its VTC and VTM heads) from the unimodal text hidden
    states.  The candidates of every row are picked on the host
    and sent to the card in one copy; the logits come back in one."""
    dev = model.device
    text_ids = torch.as_tensor(text_ids).to(dev)
    text_mask = torch.as_tensor(text_mask).to(dev)
    if isinstance(model, Clip):
        ft = _np(model.encode_text(text_ids))
        fi = np.concatenate([_np(model.encode_image(b.to(dev)))
                             for b in image_batches])
        s = fi @ ft.T
        return s, s.T
    if not isinstance(model, (ZooBase, AlproBase)):
        raise TypeError(f"zoo_sim_matrix: {type(model).__name__} is not a "
                        f"BLIP-1, ALBEF, ALPRO or CLIP model")
    fuse_hidden = isinstance(model, (AlbefBase, AlproBase))
    txt_hidden = model.unimodal_text(text_ids, text_mask)
    ft = _np(model.text_feature(txt_hidden))
    fis, embeds = [], []
    for b in image_batches:
        img = model.encode_image(b.to(dev))
        fis.append(_np(model.image_feature(img)))
        embeds.append(img)
    fi = np.concatenate(fis)
    sim = fi @ ft.T                                  # (n_img, n_txt)
    if not k_test:
        return sim, sim.T
    img_embeds = torch.cat(embeds)
    itm_text = txt_hidden if fuse_hidden else text_ids
    if not fuse_hidden and enc_token_id is not None:
        itm_text = text_ids.clone()
        itm_text[:, 0] = int(enc_token_id)

    def rerank(base, pick_text):
        out = np.full_like(base, -100.0)
        k = min(k_test, base.shape[1])
        topk = _topk_rows(base, k)
        picks = torch.from_numpy(topk.copy()).to(dev)
        logits = []
        for row in range(base.shape[0]):
            pick = picks[row]
            if pick_text:      # i2t: one image row, k texts
                t_arg, msk = itm_text[pick], text_mask[pick]
                img = img_embeds[row:row + 1].repeat(k, 1, 1)
            else:              # t2i: one text row, k images
                t_arg = itm_text[row:row + 1].repeat_interleave(k, dim=0)
                msk = text_mask[row:row + 1].repeat(k, 1)
                img = img_embeds[pick]
            logits.append(model.itm_logits(t_arg, msk, img)[:, 1])
        itm = _np(torch.stack(logits))
        rows = np.arange(base.shape[0])[:, None]
        out[rows, topk] = base[rows, topk] + itm
        return out

    return rerank(sim, True), rerank(sim.T, False)


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
        ``.dataset`` (or ``._loader.dataset``); ALPRO's batches carry
        ``video`` instead.  With no tokenizer, the
        offline ``SimpleTokenizer`` over the Q-Former's vocabulary."""
        ds = getattr(data_loader, "dataset", None)
        if ds is None:
            ds = data_loader._loader.dataset
        if isinstance(model, Blip2Qformer):
            vocab = model.cfg.qformer.vocab_size
        elif isinstance(model, (ZooBase, AlproBase, Clip)):
            vocab = (model.cfg.text if isinstance(model, Clip)
                     else model.cfg.med).vocab_size
        else:
            raise NotImplementedError(
                f"retrieval scores the stage-1 Blip2Qformer and the legacy "
                f"zoo's BLIP-1, ALBEF, ALPRO and CLIP models, not "
                f"{type(model).__name__}: the InstructBLIP compositions "
                f"have no retrieval head (in the JAX package either)")
        tokenizer = self.tokenizer or load_tokenizer(vocab_size=vocab)
        text_ids, text_mask = batch_encode(tokenizer, ds.text,
                                           self.max_txt_len)
        vis_key = "video" if isinstance(model, AlproBase) else "image"
        image_batches = (torch.as_tensor(b[vis_key], dtype=torch.float32)
                         for b in data_loader)
        if isinstance(model, Blip2Qformer):
            score_i2t, score_t2i = compute_sim_matrix(
                model, image_batches, text_ids, text_mask,
                k_test=self.k_test)
        else:
            score_i2t, score_t2i = zoo_sim_matrix(
                model, image_batches, text_ids, text_mask,
                k_test=self.k_test,
                enc_token_id=getattr(tokenizer, "enc_token_id", None))
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
