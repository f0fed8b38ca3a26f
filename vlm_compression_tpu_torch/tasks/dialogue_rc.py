"""AVSD dialogue and VQA reading comprehension (port of
``vlm_compression_tpu/tasks/dialogue_rc.py``).

* ``DialogueTask`` (``dialogue``): ``valid_step`` returns the model's
  loss on the batch; ``after_evaluation`` reports the mean as
  ``agg_metrics``.
* ``VQARCTask`` (``vqa_reading_comprehension``) runs PNP-VQA's three
  stages through ``pnp_predict_answers``: the patch relevance (the
  gradcams), ``num_captions`` caption drafts over the most relevant
  patches (draft 0 greedy, the others sampled at temperature 0.9), and the
  Fusion-in-Decoder reader's greedy answer over the [question ⊕ caption]
  contexts.  ``after_evaluation`` writes the gradcam (``.npz``), caption
  and answer results and scores the answers (VQAv2 accuracy).
* ``GQARCTask`` (``gqa_reading_comprehension``): exact match after the
  VQA normalization when generating, and the GQA leaderboard file for a
  split with no answers.

The sampled drafts draw from a ``torch.Generator`` (the JAX package from
threefry): the same seed gives other captions than JAX's, by design; a
caller holds them against another sampler by passing ``sampler``.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets.tokenization import batch_encode
from vlm_compression_tpu_torch.evaluation.vqa_eval import (
    VQAEval,
    process_digit_article,
    process_punctuation,
)
from vlm_compression_tpu_torch.tasks.base import BaseTask


def _run_value(cfg, key, default):
    run = (cfg or {}).get("run") or {}
    v = run.get(key)
    return default if v is None else v


@registry.register_task("dialogue")
class DialogueTask(BaseTask):
    """AVSD dialogue: the validation metric is the mean loss."""

    # the keys a model forward can take; the rest of a collated batch (ids,
    # raw text, ...) is dropped
    MODEL_KEYS = ("image", "input_ids", "attention_mask", "labels",
                  "token_type_ids", "video_fts",
                  "qformer_input_ids", "qformer_attention_mask",
                  "text_input_ids", "text_attention_mask")

    def __init__(self, num_beams: int = 5, max_len: int = 30,
                 min_len: int = 1, evaluate: bool = True,
                 report_metric: bool = True, prepare_batch=None,
                 tokenizer=None):
        super().__init__()
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.evaluate = evaluate
        self.report_metric = report_metric
        self.tokenizer = tokenizer
        # samples → model kwargs; the default tokenizes text_input and
        # text_output when a tokenizer is present
        self.prepare_batch = prepare_batch or self._default_prepare

    def _default_prepare(self, samples):
        batch = dict(samples)
        if "input_ids" not in batch and "text_input" in batch \
                and self.tokenizer is not None:
            ids, mask = batch_encode(self.tokenizer, batch["text_input"],
                                     self.max_len)
            batch["input_ids"], batch["attention_mask"] = ids, mask
            if "labels" not in batch:
                out_ids, out_mask = batch_encode(
                    self.tokenizer,
                    batch.get("text_output", batch["text_input"]),
                    self.max_len)
                batch["labels"] = np.where(out_mask.astype(bool), out_ids,
                                           -100)
        return batch

    @classmethod
    def setup_task(cls, cfg=None, **kw):
        """``cfg``: a mapping shaped like an eval yaml (its ``run``
        section); ``kw`` (the tokenizer) goes to the constructor."""
        return cls(num_beams=int(_run_value(cfg, "num_beams", 5)),
                   max_len=int(_run_value(cfg, "max_len", 30)),
                   min_len=int(_run_value(cfg, "min_len", 1)),
                   evaluate=bool(_run_value(cfg, "evaluate", True)),
                   report_metric=bool(_run_value(cfg, "report_metric",
                                                 True)), **kw)

    def valid_step(self, model, samples) -> List[float]:
        batch = self.prepare_batch(samples)
        dev = model.device
        batch = {k: torch.as_tensor(np.asarray(v) if isinstance(v, list)
                                    else v).to(dev)
                 for k, v in batch.items() if k in self.MODEL_KEYS
                 and isinstance(v, (np.ndarray, torch.Tensor, list))}
        return [float(model(**batch)["loss"])]

    def after_evaluation(self, val_result, split_name="val", **kw):
        if self.report_metric and val_result:
            metrics = {"agg_metrics": float(np.mean(val_result))}
        else:
            metrics = {"agg_metrics": 0.0}
        logging.info("%s dialogue loss: %s", split_name, metrics)
        return metrics


# ---------------------------------------------------------------------------
# PNP-VQA reading comprehension
# ---------------------------------------------------------------------------


def _cut_at(ids: List[int], eos: int) -> List[int]:
    return ids[:ids.index(eos)] if eos in ids else ids


@torch.no_grad()
def pnp_predict_answers(model, image, q_ids, q_mask, tokenizer,
                        num_captions: int = 2, cap_max_length: int = 12,
                        max_len: int = 8, num_patches: Optional[int] = None,
                        seed: int = 0,
                        sampler: Optional[Callable] = None):
    """(answers, captions, gradcams) of a batch: PNP-VQA's
    ``predict_answers``.  ``model``: a ``PNPVQA``; ``image``, ``q_ids``,
    ``q_mask`` tensors on its device.

    Each caption draft is decoded token by token (no cache: each step
    re-runs the caption decoder over the top patches): draft 0 greedily,
    the others by ``sampler(logits / 0.9)`` → next ids (b,) — by default a
    draw from a ``torch.Generator`` seeded with ``seed``.  The FiD reader
    then decodes the answer greedily from the [question ⊕ caption]
    contexts (tokenized at 64).  ``num_patches`` is taken for the JAX
    signature; the model's config sets the patches kept."""
    dev = model.device
    b = image.shape[0]
    # stage 1: the relevance (the "gradcams")
    rel, img = model.forward_itm(image, q_ids, q_mask)
    if sampler is None:
        gen = torch.Generator(device=dev).manual_seed(seed)

        def sampler(logits):
            return torch.multinomial(torch.softmax(logits.float(), -1), 1,
                                     generator=gen)[:, 0]

    # stage 2: the caption drafts over the top patches
    bos = getattr(tokenizer, "bos_token_id", None) or 0
    eos = getattr(tokenizer, "eos_token_id", 1)
    captions = [[] for _ in range(b)]
    for c in range(num_captions):
        seq = torch.full((b, 1), bos, dtype=torch.int64, device=dev)
        for _ in range(cap_max_length):
            last = model.forward_cap(img, rel, seq)[:, -1]
            nxt = (torch.argmax(last, dim=-1) if c == 0
                   else sampler(last / 0.9))
            seq = torch.cat([seq, nxt.to(seq.dtype)[:, None]], dim=1)
        rows = seq[:, 1:].cpu().tolist()
        for i in range(b):
            captions[i].append(tokenizer.decode(_cut_at(rows[i],
                                                         eos)).strip())

    # stage 3: the FiD reader over [question ⊕ caption], greedy
    q_rows = q_ids.cpu().tolist()
    flat = [f"{tokenizer.decode([t for t in q_rows[i] if t > 0])} {cap}"
            for i in range(b) for cap in captions[i]]
    ids, mask = batch_encode(tokenizer, flat, 64)
    ctx_ids = torch.from_numpy(ids).to(dev).reshape(b, num_captions, -1)
    ctx_mask = torch.from_numpy(mask).to(dev).reshape(b, num_captions, -1)
    reader = model.reader
    enc, enc_mask = reader.encode_contexts(ctx_ids, ctx_mask)
    dec = torch.full((b, 1), reader.cfg.decoder_start_token_id,
                     dtype=torch.int64, device=dev)
    for _ in range(max_len):
        logits = reader.t5.decode(dec, enc, enc_mask=enc_mask)
        dec = torch.cat([dec, torch.argmax(logits[:, -1], dim=-1)[:, None]],
                        dim=1)
    rows = dec[:, 1:].cpu().tolist()
    answers = [tokenizer.decode(_cut_at(rows[i], eos)).strip()
               for i in range(b)]
    return answers, captions, rel.float().cpu().numpy()


@registry.register_task("vqa_reading_comprehension")
class VQARCTask(BaseTask):
    """ReadVQA over the PNP-VQA pipeline."""

    def __init__(self, num_beams: int = 3, max_len: int = 10,
                 min_len: int = 1, evaluate: bool = True,
                 inference_method: str = "generate",
                 num_captions: int = 2, cap_max_length: int = 12,
                 tokenizer=None, sampler=None, **kwargs):
        super().__init__()
        self.num_beams = num_beams
        self.max_len = max_len
        self.min_len = min_len
        self.evaluate = evaluate
        self.inference_method = inference_method
        self.num_captions = num_captions
        self.cap_max_length = cap_max_length
        self.tokenizer = tokenizer
        self.sampler = sampler
        self.config = kwargs.get("config", {})

    @classmethod
    def setup_task(cls, cfg=None, **kw):
        """``cfg``: a mapping shaped like an eval yaml (its ``run``
        section); ``kw`` (the tokenizer) goes to the constructor."""
        return cls(num_beams=int(_run_value(cfg, "num_beams", 3)),
                   max_len=int(_run_value(cfg, "max_len", 10)),
                   min_len=int(_run_value(cfg, "min_len", 1)),
                   evaluate=bool(_run_value(cfg, "evaluate", False)),
                   inference_method=str(_run_value(cfg, "inference_method",
                                                   "generate")),
                   num_captions=int(_run_value(cfg, "num_captions", 2)),
                   cap_max_length=int(_run_value(cfg, "cap_max_length", 12)),
                   config=(cfg or {}).get("run") or {}, **kw)

    def valid_step(self, model, samples) -> List[List[Dict]]:
        dev = model.device
        q_ids, q_mask = batch_encode(self.tokenizer, samples["text_input"],
                                     32)
        answers, captions, gradcams = pnp_predict_answers(
            model, torch.as_tensor(samples["image"], dtype=torch.float32)
            .to(dev), torch.from_numpy(q_ids).to(dev),
            torch.from_numpy(q_mask).to(dev), self.tokenizer,
            num_captions=self.num_captions,
            cap_max_length=self.cap_max_length, max_len=self.max_len,
            sampler=self.sampler)
        trip = [[], [], []]
        for i, qid in enumerate(samples["question_id"]):
            qid = int(qid)
            trip[0].append({"question_id": qid,
                            "gradcam": gradcams[i].tolist()})
            trip[1].append({"question_id": qid, "caption": captions[i]})
            rec = {"question_id": qid, "answer": answers[i]}
            if "answers" in samples:
                rec["gt_answers"] = samples["answers"][i]
            trip[2].append(rec)
        return [trip]

    def after_evaluation(self, val_result, split_name="test", epoch="eval",
                         result_dir="result", **kw):
        gradcams = [g for t in val_result for g in t[0]]
        captions = [c for t in val_result for c in t[1]]
        answers = [a for t in val_result for a in t[2]]
        self.save_gradcam(gradcams, result_dir,
                          f"{split_name}_gradcam_result",
                          remove_duplicate="question_id")
        self.save_result(captions, result_dir,
                         f"{split_name}_caption_result",
                         remove_duplicate="question_id")
        f = self.save_result(answers, result_dir,
                             f"{split_name}_vqa_result",
                             remove_duplicate="question_id")
        return self._report_metrics(f, split_name, result_dir)

    @staticmethod
    def save_gradcam(result, result_dir, filename, remove_duplicate=""):
        """One ``.npz`` shard per process (the records as one JSON string),
        merged by rank 0."""
        os.makedirs(result_dir, exist_ok=True)
        dist = torch.distributed.is_available() and \
            torch.distributed.is_initialized()
        rank = torch.distributed.get_rank() if dist else 0
        world = torch.distributed.get_world_size() if dist else 1
        shard = os.path.join(result_dir, f"{filename}_rank{rank}.npz")
        np.savez_compressed(
            shard, result=np.array(json.dumps(result), dtype=object))
        if dist and world > 1:
            torch.distributed.barrier()
        final = os.path.join(result_dir, f"{filename}.npz")
        if rank == 0:
            merged, seen = [], set()
            for r in range(world):
                p = os.path.join(result_dir, f"{filename}_rank{r}.npz")
                if not os.path.exists(p):
                    continue
                with np.load(p, allow_pickle=True) as shard_file:
                    part = json.loads(str(shard_file["result"]))
                for item in part:
                    if remove_duplicate:
                        if item[remove_duplicate] in seen:
                            continue
                        seen.add(item[remove_duplicate])
                    merged.append(item)
            np.savez_compressed(
                final, result=np.array(json.dumps(merged), dtype=object))
        return final

    def _report_metrics(self, result_file, split_name, result_dir):
        with open(result_file) as fh:
            results = json.load(fh)
        scored = [r for r in results if "gt_answers" in r]
        if not scored:
            return {"agg_metrics": 0.0}
        acc = VQAEval().evaluate(scored)
        metrics = {"agg_metrics": acc["overall"], **acc}
        with open(os.path.join(result_dir, "..", "evaluate.txt"), "a") as fh:
            fh.write(json.dumps({split_name: metrics}) + "\n")
        return metrics


@registry.register_task("gqa_reading_comprehension")
class GQARCTask(VQARCTask):
    """GQA-RC: exact match after the VQA normalization; the leaderboard
    file for a split with no answers."""

    def valid_step(self, model, samples):
        trip = super().valid_step(model, samples)[0]
        # answer records as prediction / ground-truth pairs
        for rec, gt in zip(trip[2], samples.get("answer",
                                                [None] * len(trip[2]))):
            rec["pred_ans"] = rec.pop("answer")
            rec["gt_ans"] = (gt if gt is not None
                             else (rec.get("gt_answers") or [None])[0])
        return [trip]

    def _report_metrics(self, result_file, split_name, result_dir):
        with open(result_file) as fh:
            results = json.load(fh)
        acc = []
        for res in results:
            if res.get("gt_ans") is None:
                self._save_result_leaderboard(results, result_dir)
                return {"agg_metrics": 0.0}
            pred = res["pred_ans"]
            if self.inference_method == "generate":
                pred = process_digit_article(process_punctuation(pred))
            acc.append(1 if pred == res["gt_ans"] else 0)
        accuracy = sum(acc) / max(len(acc), 1) * 100
        metrics = {"agg_metrics": accuracy, "acc": accuracy}
        with open(os.path.join(result_dir, "..", "evaluate.txt"), "a") as fh:
            fh.write(json.dumps(metrics) + "\n")
        logging.info(metrics)
        return metrics

    @staticmethod
    def _save_result_leaderboard(results, result_dir):
        board = [{"questionId": str(r["question_id"]),
                  "prediction": str(r["pred_ans"])} for r in results]
        path = os.path.join(result_dir, "leaderboard.json")
        with open(path, "w") as f:
            json.dump(board, f)
        logging.info("Saved leaderboard results at %s", path)
