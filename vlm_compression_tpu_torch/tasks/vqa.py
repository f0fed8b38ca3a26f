"""VQA / OK-VQA / GQA tasks — answers generated (or ranked over a candidate
list) by InstructBLIP-T5, InstructBLIP-Vicuna or BLIP-2 OPT and scored with
the official metrics (port of ``vlm_compression_tpu/tasks/vqa.py``).

``valid_step`` formats each question with the prompt, encodes it for the
Q-Former and for the language model (128 tokens; for Vicuna and OPT
left-padded with BOS first; OPT's Q-Former takes no text) and either
generates a short answer (beam search, ``max_len`` new tokens) or, with
``answer_list`` set, picks the candidate of least NLL
(``predict_class_t5`` on T5; every other model goes to
``predict_class_vicuna``, as in the JAX package, which ranks on Vicuna
only).  With ``speculative_gamma`` set (the run config's, or the CLI's
``--speculative_gamma``) the answers
are the dense teacher's greedy decode, the masked student drafting: beams
give way to greedy, with a warning, as in the JAX package; ``spec_stats``
sums the decodes' ``rounds``, ``committed`` and ``rows``.
``after_evaluation`` saves the
results (a shard per process, merged) and reports the VQAv2 accuracy, or
GQA's exact match, appending it to ``result_dir/../evaluate.txt``.

Ground-truth answers ride along in the sample dicts as ``answers``.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Dict, List

import numpy as np
import torch

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets.tokenization import (
    batch_encode,
    batch_labels,
)
from vlm_compression_tpu_torch.evaluation.lemmatize import lemmatize
from vlm_compression_tpu_torch.evaluation.vqa_eval import (
    VQAEval,
    gqa_exact_match,
)
from vlm_compression_tpu_torch.models.blip2_opt import Blip2OPT, generate_opt
from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
    Blip2T5Instruct,
    generate_t5,
    predict_class_t5,
)
from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
    Blip2VicunaInstruct,
    generate_vicuna,
    predict_class_vicuna,
)
from vlm_compression_tpu_torch.models.generation import GenerationConfig
from vlm_compression_tpu_torch.tasks.base import BaseTask

_GENERATORS = (Blip2T5Instruct, Blip2VicunaInstruct, Blip2OPT)


@registry.register_task("vqa")
@registry.register_task("aok_vqa")
class VQATask(BaseTask):
    def __init__(self, num_beams: int = 5, max_len: int = 10,
                 min_len: int = 1, prompt: str = "",
                 tokenizer=None, qformer_tokenizer=None,
                 sample_id_key: str = "question_id",
                 apply_lemmatizer: bool = False,
                 speculative_gamma: int = 0, **kw):
        super().__init__()
        self.num_beams = num_beams
        self.speculative_gamma = speculative_gamma
        self.max_len = max_len
        self.min_len = min_len
        self.prompt = prompt
        self.tokenizer = tokenizer
        self.qformer_tokenizer = qformer_tokenizer or tokenizer
        self.sample_id_key = sample_id_key
        self.apply_lemmatizer = apply_lemmatizer
        self.answer_list = None
        self.spec_stats = {"rounds": 0, "committed": 0, "rows": 0}

    @classmethod
    def setup_task(cls, cfg=None, **kw):
        """``cfg``: a mapping shaped like an eval yaml, its ``run`` and
        ``model`` sections (``apply_lemmatizer`` is read from either, as
        the OK-VQA yamls set it on the model).  ``kw`` (the tokenizers)
        goes to the constructor."""
        cfg = cfg or {}
        run, model = cfg.get("run") or {}, cfg.get("model") or {}
        return cls(num_beams=int(run.get("num_beams", 5)),
                   max_len=int(run.get("max_len", 10)),
                   min_len=int(run.get("min_len", 1)),
                   prompt=str(run.get("prompt", "")),
                   apply_lemmatizer=bool(model.get("apply_lemmatizer", False)
                                         or run.get("apply_lemmatizer",
                                                    False)),
                   speculative_gamma=int(run.get("speculative_gamma", 0)),
                   **kw)

    # ------------------------------------------------------------------
    def _decode(self, seqs) -> List[str]:
        """Token rows (decoder start first) → answer strings, cut at EOS."""
        tok = self.tokenizer
        out = []
        for row in np.asarray(seqs):
            ids = [int(t) for t in row[1:]]
            if hasattr(tok, "eos_token_id") and tok.eos_token_id in ids:
                ids = ids[:ids.index(tok.eos_token_id)]
            text = tok.decode(ids) if not hasattr(tok, "batch_decode") else \
                tok.decode(ids, skip_special_tokens=True)
            out.append(text.strip())
        return out

    def _prompts(self, samples) -> List[str]:
        return [self.prompt.format(q) if "{}" in self.prompt
                else self.prompt + q for q in samples["text_input"]]

    def _encode(self, model, samples, decoder_only: bool = False):
        """(image, LM ids, LM mask, Q-Former ids, Q-Former mask) on the
        model's device; ``decoder_only``: the LM prompt left-padded, BOS
        first."""
        questions = self._prompts(samples)
        dev = model.device

        def t(a):
            return torch.from_numpy(np.asarray(a)).to(dev)

        ids, mask = batch_encode(self.tokenizer, questions, 128,
                                 left_pad=decoder_only, add_bos=decoder_only)
        q_ids, q_mask = batch_encode(self.qformer_tokenizer, questions, 128)
        image = torch.as_tensor(samples["image"], dtype=torch.float32,
                                device=dev)
        return image, t(ids), t(mask), t(q_ids), t(q_mask)

    def _records(self, samples, answers) -> List[Dict]:
        out = []
        for i, ans in enumerate(answers):
            rec = {"question_id": samples[self.sample_id_key][i],
                   "answer": ans}
            if "answers" in samples:
                rec["gt_answers"] = samples["answers"][i]
            out.append(rec)
        return out

    def valid_step(self, model, samples) -> List[Dict]:
        """model: an InstructBLIP-T5 (``Blip2T5Instruct``), -Vicuna
        (``Blip2VicunaInstruct``) or BLIP-2 OPT (``Blip2OPT``).  With
        ``answer_list`` set, answers are ranked by NLL over the candidates
        instead of generated."""
        if self.answer_list:
            return self._rank_step(model, samples)
        if not isinstance(model, _GENERATORS):
            raise TypeError(
                f"the VQA tasks generate with InstructBLIP-T5, "
                f"InstructBLIP-Vicuna or BLIP-2 OPT, not "
                f"{type(model).__name__}")
        opt = isinstance(model, Blip2OPT)
        vicuna = isinstance(model, Blip2VicunaInstruct)
        image, ids, mask, q_ids, q_mask = self._encode(
            model, samples, decoder_only=vicuna or opt)
        eos = (dict(eos_token_id=2, pad_token_id=1) if opt
               else dict(eos_token_id=model.cfg.llm.eos_token_id) if vicuna
               else {})
        gen_cfg = GenerationConfig(
            num_beams=self.num_beams, max_length=self.max_len + 1,
            min_length=self.min_len, **eos)
        gen_cfg, spec_kw = self._spec(gen_cfg)
        if opt:
            # BLIP-2 OPT's Q-Former takes no instruction text
            seqs = generate_opt(model, image, ids, mask, gen_cfg=gen_cfg,
                                **spec_kw)
        else:
            generate = generate_vicuna if vicuna else generate_t5
            seqs = generate(model, image, ids, mask, q_ids, q_mask,
                            gen_cfg=gen_cfg, **spec_kw)
        if spec_kw:
            for key in ("rounds", "committed"):
                self.spec_stats[key] += spec_kw["stats"][key]
            self.spec_stats["rows"] += len(seqs)
        answers = self._decode(seqs.cpu())
        if self.apply_lemmatizer:
            answers = lemmatize(answers)
        return self._records(samples, answers)

    def _spec(self, gen_cfg):
        """(gen_cfg, extra generate kwargs) for speculative serving: the
        masked student drafts, the dense teacher verifies, greedy."""
        if self.speculative_gamma <= 0:
            return gen_cfg, {}
        if self.num_beams > 1:
            logging.warning(
                "speculative_gamma=%d replaces num_beams=%d with greedy "
                "draft-and-verify (answers = the dense teacher's GREEDY "
                "decode, not beam search)", self.speculative_gamma,
                self.num_beams)
        return (dataclasses.replace(gen_cfg, num_beams=1),
                dict(llm_mode="dense", draft_llm_mode="masked",
                     speculative_gamma=self.speculative_gamma, stats={}))

    def _rank_step(self, model, samples) -> List[Dict]:
        """T5 scores -100-padded labels; any other model goes to
        ``predict_class_vicuna`` (right-padded prompts, no BOS, as in the
        JAX package), which takes InstructBLIP-Vicuna alone."""
        image, ids, mask, q_ids, q_mask = self._encode(model, samples)
        if isinstance(model, Blip2T5Instruct):
            cands = batch_labels(self.tokenizer, self.answer_list,
                                 self.max_len)
            nll = predict_class_t5(model, image, ids, mask,
                                   torch.from_numpy(cands), q_ids, q_mask)
        else:
            c_ids, c_mask = batch_encode(self.tokenizer, self.answer_list,
                                         self.max_len)
            nll = predict_class_vicuna(
                model, image, ids, mask, torch.from_numpy(c_ids),
                torch.from_numpy(c_mask), q_ids, q_mask)
        # argmin: the first candidate on ties
        best = torch.argmin(nll, dim=-1).cpu().tolist()
        return self._records(samples, [self.answer_list[b] for b in best])

    # ------------------------------------------------------------------
    def after_evaluation(self, val_result, split_name="test", epoch="eval",
                         result_dir="result", **kw):
        f = self.save_result(val_result, result_dir,
                             f"{split_name}_vqa_result",
                             remove_duplicate="question_id")
        # the runner's model-size accounting, for the metric report
        self._sizes = {k: kw[k] for k in
                       ("orig_total_size", "distilled_total_size") if k in kw}
        return self._report_metrics(f, split_name, result_dir)

    def _size_metrics(self) -> Dict:
        s = getattr(self, "_sizes", {})
        if not s:
            return {}
        # billions, 3 decimals
        return {"orig_size": f"{s['orig_total_size'] / 10 ** 9:.3f} B",
                "dist_size": f"{s['distilled_total_size'] / 10 ** 9:.3f} B"}

    def _write_metrics(self, metrics, split_name, result_dir):
        with open(os.path.join(result_dir, "..", "evaluate.txt"), "a") as fh:
            fh.write(json.dumps({split_name: metrics}) + "\n")

    def _report_metrics(self, result_file, split_name, result_dir):
        with open(result_file) as fh:
            results = json.load(fh)
        scored = [r for r in results if "gt_answers" in r]
        if not scored:
            return {"agg_metrics": 0.0}
        acc = VQAEval().evaluate(scored)
        metrics = {**self._size_metrics(),
                   "agg_metrics": acc["overall"], **acc}
        logging.info("%s VQA accuracy: %s", split_name, acc)
        self._write_metrics(metrics, split_name, result_dir)
        return metrics


@registry.register_task("gqa")
class GQATask(VQATask):
    def _report_metrics(self, result_file, split_name, result_dir):
        with open(result_file) as fh:
            results = json.load(fh)
        scored = [r for r in results if "gt_answers" in r]
        acc = gqa_exact_match(scored)
        metrics = {**self._size_metrics(), "agg_metrics": acc, "acc": acc}
        logging.info("%s GQA accuracy: %.2f", split_name, acc)
        self._write_metrics(metrics, split_name, result_dir)
        return metrics
