"""The port's VQA evaluation path vs the JAX package on the CPU: the
collation of ``datasets/tokenization.py`` and the text processors (arrays
and strings equal), the official VQAv2 accuracy, GQA exact match and the
OK-VQA lemmatizer (equal, floats included), the 5-dim (video) branch of
``encode_image`` (tiny fp32, atol = rtol = 1e-5), ``predict_class_t5``
(tiny fp32 NLLs, atol = rtol = 1e-4, argmin equal), and the ``vqa`` /
``gqa`` tasks end to end — answers, metrics, the merged result file and
the ``evaluate.txt`` line equal to the JAX tasks', with beams, greedy and
``speculative_gamma`` (batch-shared, per-row and int8 KV caches).
"""

import dataclasses
import json
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from test_torch_models import tiny_blip
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.common.registry import registry as jax_registry
from vlm_compression_tpu.datasets import processors as JP
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.evaluation import lemmatize as JL
from vlm_compression_tpu.evaluation import vqa_eval as JE
from vlm_compression_tpu.models import blip2_t5_instruct as JB
from vlm_compression_tpu.tasks import vqa as JQ
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets import processors as TP
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.evaluation import lemmatize as TL
from vlm_compression_tpu_torch.evaluation import vqa_eval as TE
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
from vlm_compression_tpu_torch.models.factory import set_kv_cache_
from vlm_compression_tpu_torch.tasks import base as TBase
from vlm_compression_tpu_torch.tasks import vqa as TQ

ROOT = Path(__file__).resolve().parents[1]
PROMPT = "Question: {} Short answer:"


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------ tokenization

TEXTS = ["what is the man holding", "", "a b c d e f g h i j k l",
         "  spaces   between\twords\n", "one"]


@pytest.mark.parametrize("kw", [
    dict(max_len=128), dict(max_len=4), dict(max_len=128, left_pad=True),
    dict(max_len=5, left_pad=True, add_bos=True),
    dict(max_len=128, add_bos=True, add_eos=True),
    dict(max_len=3, add_eos=True, pad_id=7), dict(max_len=1)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
@pytest.mark.parametrize("texts", [TEXTS, [""], ["", ""]],
                         ids=["mixed", "empty", "two_empty"])
def test_batch_encode_matches_jax(texts, kw):
    jt, tt = JTok.SimpleTokenizer(96), TTok.SimpleTokenizer(96)
    want = JTok.batch_encode(jt, texts, **kw)
    got = TTok.batch_encode(tt, texts, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("max_len,add_eos", [(10, True), (2, True),
                                             (10, False), (1, False)])
def test_batch_labels_matches_jax(max_len, add_eos):
    want = JTok.batch_labels(JTok.SimpleTokenizer(), TEXTS, max_len, add_eos)
    got = TTok.batch_labels(TTok.SimpleTokenizer(), TEXTS, max_len, add_eos)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_txt,max_out", [(128, 16), (3, 2), (1, 1)])
def test_pack_qa_matches_jax(max_txt, max_out):
    prompts = TEXTS
    answers = ["two", "", "red and blue", "yes", "a very long answer indeed"]
    want = JTok.pack_qa(JTok.SimpleTokenizer(), prompts, answers, max_txt,
                        max_out)
    got = TTok.pack_qa(TTok.SimpleTokenizer(), prompts, answers, max_txt,
                       max_out)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_simple_tokenizer_ids_and_decode_match_jax():
    jt, tt = JTok.SimpleTokenizer(32128), TTok.SimpleTokenizer(32128)
    words = "what colour is the zebra crossing ? 1,000 don't".split()
    for w in words:
        assert tt._tok(w) == jt._tok(w)
    ids = tt.encode(" ".join(words), add_bos=True, add_eos=True)
    assert ids == jt.encode(" ".join(words), add_bos=True, add_eos=True)
    assert tt.decode(ids + [0, 0]) == jt.decode(ids + [0, 0])


def test_load_tokenizer_without_a_path_is_simple_and_with_one_needs_hf(
        monkeypatch):
    tok = TTok.load_tokenizer(vocab_size=96)
    assert isinstance(tok, TTok.SimpleTokenizer) and tok.vocab_size == 96
    # transformers cannot be imported: a path raises, never falls back
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError):
        TTok.load_tokenizer("/nonexistent/local/snapshot")


# --------------------------------------------------------- text processors

RAW = ["What is the man's dog (left) doing?!", "  Many   spaces\there. ",
       "colon: semi; tilde~ star* hash# quote\" end.\n",
       "one two three four five six seven", "", "UPPER lower"]


@pytest.mark.parametrize("max_words", [None, 3, 1, 50])
def test_text_processors_match_jax(max_words):
    for s in RAW:
        assert TP.pre_question(s, max_words) == JP.pre_question(s, max_words)
        assert TP.pre_caption(s, max_words) == JP.pre_caption(s, max_words)
    kw = {} if max_words is None else dict(max_words=max_words)
    tq, jq = TP.BlipQuestionProcessor(**kw), JP.BlipQuestionProcessor(**kw)
    tc = TP.BlipCaptionProcessor(prompt="a photo of ", **kw)
    jc = JP.BlipCaptionProcessor(prompt="a photo of ", **kw)
    for s in RAW:
        assert tq(s) == jq(s) and tc(s) == jc(s)


# ----------------------------------------------------------------- metrics

_WORDS = (sorted(TE.NUMBER_MAP) + sorted(TE.ARTICLES)
          + sorted(TE.CONTRACTIONS)[:40]
          + ["dog", "red", "2", "1,000", "3.5", "10", "Yes", "no", "<17>"])
_PUNCT = TE.PUNCT + [".", ",", "'", " ", "\n", "\t"]
_answer = st.lists(
    st.one_of(st.sampled_from(_WORDS), st.sampled_from(_PUNCT)),
    max_size=5).map("".join)


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(pred=_answer, gts=st.lists(_answer, max_size=10))
def test_vqa_accuracy_and_normalization_match_jax(pred, gts):
    assert TE.normalize_answer(pred) == JE.normalize_answer(pred)
    assert TE.vqa_accuracy(pred, gts) == JE.vqa_accuracy(pred, gts)


@settings(max_examples=60, deadline=None, database=None, derandomize=True)
@given(rows=st.lists(st.tuples(_answer, st.lists(_answer, min_size=1,
                                                 max_size=10),
                               st.sampled_from(["", "yes/no", "number",
                                                "other"])),
                     max_size=12))
def test_vqa_eval_and_gqa_exact_match_match_jax(rows):
    results = [{"question_id": i, "answer": p, "gt_answers": g,
                **({"answer_type": t} if t else {})}
               for i, (p, g, t) in enumerate(rows)]
    assert TE.VQAEval().evaluate(results) == JE.VQAEval().evaluate(results)
    ev_t, ev_j = TE.VQAEval(n=3), JE.VQAEval(n=3)
    assert ev_t.evaluate(results) == ev_j.evaluate(results)
    assert ev_t.eval_qa == ev_j.eval_qa
    assert TE.gqa_exact_match(results) == JE.gqa_exact_match(results)
    single = [dict(r, gt_answers=r["gt_answers"][0]) for r in results]
    assert TE.gqa_exact_match(single) == JE.gqa_exact_match(single)


def _closed_form(k: int) -> float:
    """VQAv2 accuracy of an answer held by k of 10 annotators."""
    return (k * min(1.0, (k - 1) / 3) + (10 - k) * min(1.0, k / 3)) / 10


@pytest.mark.parametrize("k", range(11))
def test_vqa_accuracy_closed_form(k):
    gts = ["two dogs"] * k + ["cat"] * (10 - k)
    # each prediction normalizes to the held answer's "2 dogs"
    for pred in ("two dogs", "Two  dogs!", "2 dogs"):
        got = TE.vqa_accuracy(pred, gts)
        assert got == pytest.approx(_closed_form(k), abs=1e-12)
        assert got == JE.vqa_accuracy(pred, gts)


def test_vqa_eval_reports_the_closed_form_over_k():
    results = [{"question_id": i, "answer": "two dogs",
                "gt_answers": ["two dogs"] * (i % 11)
                + ["never said"] * (10 - i % 11)} for i in range(64)]
    want = round(100 * sum(_closed_form(i % 11) for i in range(64)) / 64, 2)
    assert TE.VQAEval().evaluate(results)["overall"] == want
    assert JE.VQAEval().evaluate(results)["overall"] == want


# --------------------------------------------------------------- lemmatizer

LEMMA_WORDS = (sorted(JL._IRREGULAR) + sorted(JL._KEEP) + [
    "berries", "flies", "ties", "dishes", "boxes", "buzzes", "glasses",
    "churches", "potatoes", "heroes", "dogs", "cats", "bus", "virus",
    "tennis", "grass", "stopping", "running", "skiing", "hopping",
    "smiling", "baking", "riding", "eating", "walking", "filling",
    "passing", "stopped", "baked", "hoped", "used", "walked", "filled",
    "kissed", "played", "ing", "bed", "red", "Dogs", "USA", "t-shirt",
    "2", "<123>", "", "it's", "cooking", "using"])


def test_lemmatize_rules_match_jax(monkeypatch):
    for mod in (TL, JL):
        monkeypatch.setattr(mod, "_SPACY", False)
    words = LEMMA_WORDS
    assert TL.lemmatize(words) == JL.lemmatize(words)
    answers = ["two dogs running", "men riding horses", "<5> <17>", "",
               "the skiing boxes"]
    assert TL.lemmatize(answers) == JL.lemmatize(answers)
    assert TL.lemmatize(["dogs", "skiing", "stopped", "is"]) == \
        ["dog", "ski", "stop", "is"]


class _Tok:
    def __init__(self, text, pos, lemma):
        self.text, self.pos_, self.lemma_ = text, pos, lemma


def test_lemmatize_uses_spacy_where_it_loads_as_jax_does(monkeypatch):
    """With a spaCy that loads ``en_core_web_sm``, both packages probe it
    the same way and keep the lemma of NOUN/VERB tokens only."""
    loaded = []

    def nlp(text):
        return [_Tok(w, "NOUN" if w.endswith("s") else "ADJ", w.upper())
                for w in text.split()]

    def load(name):
        loaded.append(name)
        return nlp

    monkeypatch.setitem(sys.modules, "spacy", types.SimpleNamespace(load=load))
    for mod in (TL, JL):
        monkeypatch.setattr(mod, "_SPACY", None)
    answers = ["red dogs", "cats", "green"]
    assert TL.lemmatize(answers) == JL.lemmatize(answers) == \
        ["red DOGS", "CATS", "green"]
    assert loaded == ["en_core_web_sm"] * 2
    # a spaCy that fails to load: the rule path in both
    for mod in (TL, JL):
        monkeypatch.setattr(mod, "_SPACY", None)
    monkeypatch.setitem(sys.modules, "spacy", types.SimpleNamespace(
        load=lambda name: (_ for _ in ()).throw(OSError(name))))
    assert TL.lemmatize(answers) == JL.lemmatize(answers) == \
        ["red dog", "cat", "green"]
    assert TL._SPACY is False and JL._SPACY is False


# ------------------------------------------------------------------ models


@pytest.fixture(scope="module")
def tiny():
    """(jax module, jax variables, port module) of tiny fp32
    InstructBLIP-T5 with random masks, parameters shared by the bridge."""
    jm, variables, tm, _ = tiny_blip(seed=31, masks=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm


def _ids(rng, b, n, vocab):
    return rng.integers(2, vocab, (b, n)).astype(np.int32)


@pytest.mark.parametrize("with_qformer_text", [True, False])
def test_video_encode_image_matches_jax(tiny, with_qformer_text):
    jm, variables, tm = tiny
    rng = np.random.default_rng(32)
    img = jm.cfg.vit.img_size
    video = rng.standard_normal((2, 3, img, img, 3)).astype(np.float32)
    q_ids = _ids(rng, 2, 5, jm.cfg.qformer.vocab_size)
    q_mask = np.ones((2, 5), np.int32)
    q_mask[1, -2:] = 0
    args = (q_ids, q_mask) if with_qformer_text else (None, None)
    want = jm.apply(variables, jnp.asarray(video), "masked",
                    *[None if a is None else jnp.asarray(a) for a in args],
                    "masked", method=JB.Blip2T5Instruct.encode_image)
    with torch.no_grad():
        got = tm.encode_image(_t(video), "masked",
                              *[None if a is None else _t(a) for a in args],
                              "masked")
    nq = jm.cfg.qformer.num_query_tokens
    assert tuple(got.shape) == (2, 3 * nq, jm.cfg.t5.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # frame j of request i is the 4-dim encoding of that frame alone
    with torch.no_grad():
        frame = tm.encode_image(_t(video[1, 2:3]), "masked",
                                *[None if a is None else _t(a[1:2])
                                  for a in args], "masked")
    torch.testing.assert_close(got[1:2, 2 * nq:], frame, atol=1e-5,
                               rtol=1e-5)


def _rank_inputs(tiny, seed):
    jm, _, _ = tiny
    rng = np.random.default_rng(seed)
    img = jm.cfg.vit.img_size
    b = 3
    mask = np.ones((b, 6), np.int32)
    mask[0, -2:] = 0
    inputs = dict(
        image=rng.standard_normal((b, img, img, 3)).astype(np.float32),
        input_ids=_ids(rng, b, 6, jm.cfg.t5.vocab_size),
        attention_mask=mask,
        qformer_input_ids=_ids(rng, b, 6, jm.cfg.qformer.vocab_size),
        qformer_attention_mask=np.ones((b, 6), np.int32))
    cands = JTok.batch_labels(JTok.SimpleTokenizer(jm.cfg.t5.vocab_size),
                              ["yes", "no", "two dogs", "a red car", "",
                               "green", "one two three four five"], 4)
    return inputs, cands


def test_predict_class_t5_matches_jax(tiny):
    jm, variables, tm = tiny
    inputs, cands = _rank_inputs(tiny, 33)
    order = ("image", "input_ids", "attention_mask")
    want = np.asarray(JB.predict_class_t5(
        jm, variables, *[jnp.asarray(inputs[k]) for k in order],
        jnp.asarray(cands), jnp.asarray(inputs["qformer_input_ids"]),
        jnp.asarray(inputs["qformer_attention_mask"])))
    got = TB.predict_class_t5(
        tm, *[_t(inputs[k]) for k in order], _t(cands),
        _t(inputs["qformer_input_ids"]),
        _t(inputs["qformer_attention_mask"])).numpy()
    assert got.shape == want.shape == (3, len(cands))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmin(-1), want.argmin(-1))


def test_predict_class_t5_chunks_whole_candidates(tiny, monkeypatch):
    """The candidates go through the decoder in chunks bounded by the
    logits' bytes; a chunk of one candidate gives each row the same sum."""
    _, _, tm = tiny
    inputs, cands = _rank_inputs(tiny, 34)
    args = [_t(inputs[k]) for k in ("image", "input_ids", "attention_mask")]
    extra = [_t(inputs["qformer_input_ids"]),
             _t(inputs["qformer_attention_mask"])]
    whole = TB.predict_class_t5(tm, *args, _t(cands), *extra)
    monkeypatch.setattr(TB, "_LOGIT_BYTES", 1)
    chunked = TB.predict_class_t5(tm, *args, _t(cands), *extra)
    torch.testing.assert_close(chunked, whole, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------- tasks


def _samples(tiny, seed, b=4):
    jm, _, _ = tiny
    rng = np.random.default_rng(seed)
    img = jm.cfg.vit.img_size
    words = ["what", "is", "the", "man", "holding", "color", "dog", "how",
             "many", "cars", "are", "there", "left", "sky"]
    return {
        "image": rng.standard_normal((b, img, img, 3)).astype(np.float32),
        "text_input": [" ".join(rng.choice(words, rng.integers(2, 7)))
                       + "?" for _ in range(b)],
        "question_id": list(range(b)),
        "image_id": list(range(b)),
        "instance_id": list(range(b)),
    }


def _tasks(tiny, cls_name, **kw):
    jm, variables, tm = tiny
    toks = {}
    for side, mod in (("jax", JTok), ("torch", TTok)):
        toks[side] = dict(
            tokenizer=mod.SimpleTokenizer(jm.cfg.t5.vocab_size),
            qformer_tokenizer=mod.SimpleTokenizer(jm.cfg.qformer.vocab_size))
    jt = getattr(JQ, cls_name)(**kw, **toks["jax"])
    tt = getattr(TQ, cls_name)(**kw, **toks["torch"])
    return (jt, FlaxModel(jm, variables)), (tt, tm)


def _with_gt(samples, answers):
    """gt: the model's own answer for the even questions (in 2 of 10 slots
    for question 0, all 10 for question 2), another string elsewhere."""
    out = dict(samples)
    out["answers"] = [
        ([a] * (2 if i == 0 else 10) + ["no answer"] * (8 if i == 0 else 0))
        if i % 2 == 0 else ["never produced"] * 10
        for i, a in enumerate(answers)]
    return out


def _evaluate_both(jax_task, torch_task, samples, tmp_path):
    (jt, jmodel), (tt, tmodel) = jax_task, torch_task
    want = jt.evaluation(jmodel, [samples])
    with torch.no_grad():
        got = tt.evaluation(tmodel, [samples])
    assert got == want
    metrics = []
    for side, task, res in (("jax", jt, want), ("torch", tt, got)):
        rd = tmp_path / side / "result"
        rd.mkdir(parents=True)
        metrics.append(task.after_evaluation(
            res, split_name="val", result_dir=str(rd),
            orig_total_size=4_023_000_000, distilled_total_size=2_500_000_000))
    assert metrics[0] == metrics[1]
    for name in ("result/val_vqa_result.json", "evaluate.txt"):
        assert (tmp_path / "torch" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()
    return got, metrics[1]


@pytest.mark.parametrize("cls_name,beams,lemmatize", [
    ("VQATask", 1, False), ("VQATask", 2, True), ("GQATask", 1, False),
    ("GQATask", 2, False)])
def test_generate_mode_tasks_match_jax(tiny, tmp_path, cls_name, beams,
                                       lemmatize):
    jax_task, torch_task = _tasks(tiny, cls_name, num_beams=beams,
                                  max_len=4, min_len=1, prompt=PROMPT,
                                  apply_lemmatizer=lemmatize)
    samples = _samples(tiny, 35)
    first = torch_task[0].evaluation(torch_task[1], [samples])
    assert all("gt_answers" not in r for r in first)
    got, metrics = _evaluate_both(
        jax_task, torch_task,
        _with_gt(samples, [r["answer"] for r in first]), tmp_path)
    assert [r["answer"] for r in got] == [r["answer"] for r in first]
    if cls_name == "GQATask":
        assert metrics["acc"] == 50.0
    else:   # (0.6 + 0 + 1 + 0) / 4
        assert metrics["overall"] == round(100 * (_closed_form(2) + 1) / 4, 2)
    assert metrics["orig_size"] == "4.023 B"


@pytest.mark.parametrize("cls_name,beams,per_row,int8", [
    ("GQATask", 2, False, False), ("GQATask", 1, True, False),
    ("VQATask", 1, False, True)],
    ids=["gqa_beams_to_greedy", "gqa_per_row", "okvqa_int8"])
def test_speculative_tasks_match_jax(tiny, tmp_path, cls_name, beams,
                                     per_row, int8, caplog, monkeypatch):
    """``speculative_gamma``: the masked student drafts, the dense teacher
    verifies, beams give way to greedy with a warning; answers, metrics
    and files equal the JAX task's, the answers the dense greedy's."""
    jm, variables, tm = tiny
    jm = JB.Blip2T5Instruct(dataclasses.replace(jm.cfg, t5=dataclasses.replace(
        jm.cfg.t5, kv_cache_per_row=per_row, kv_cache_int8=int8)))
    set_kv_cache_(tm, int8=int8, per_row=per_row)
    try:
        kw = dict(num_beams=beams, max_len=4, min_len=1, prompt=PROMPT)
        jax_task, torch_task = _tasks((jm, variables, tm), cls_name,
                                      speculative_gamma=2, **kw)
        samples = _samples(tiny, 39)
        with caplog.at_level("WARNING"):
            first = torch_task[0].evaluation(tm, [samples])
        assert ("replaces num_beams" in caplog.text) == (beams > 1)
        answers = [r["answer"] for r in first]
        got, _ = _evaluate_both(jax_task, torch_task,
                                _with_gt(samples, answers), tmp_path)
        assert [r["answer"] for r in got] == answers
        stats = torch_task[0].spec_stats
        assert stats["rows"] == 2 * len(answers) and stats["rounds"] >= 2
        teacher = TQ.generate_t5
        monkeypatch.setattr(TQ, "generate_t5", lambda *a, **k: teacher(
            *a, **dict(k, llm_mode="dense")))
        _, dense = _tasks((jm, variables, tm), cls_name, **dict(kw,
                                                               num_beams=1))
        assert [r["answer"] for r in dense[0].evaluation(tm, [samples])] \
            == answers
    finally:
        set_kv_cache_(tm)


@pytest.mark.parametrize("cls_name", ["VQATask", "GQATask"])
def test_rank_mode_tasks_match_jax(tiny, tmp_path, cls_name):
    jax_task, torch_task = _tasks(tiny, cls_name, max_len=4, prompt=PROMPT)
    answer_list = ["yes", "no", "two", "red car", "a dog", "green", "left",
                   "yes"]
    jax_task[0].answer_list = torch_task[0].answer_list = answer_list
    samples = dict(_samples(tiny, 36, b=3),
                   answers=[["yes"] * 10, ["two"] * 3 + ["no"] * 7,
                            ["green"]])
    got, _ = _evaluate_both(jax_task, torch_task, samples, tmp_path)
    assert all(r["answer"] in answer_list for r in got)


def test_rank_mode_takes_the_first_minimum_as_jax_does(tiny, monkeypatch):
    """Ties in the NLL matrix go to the first candidate, in both."""
    nll = np.array([[1.0, 0.5, 0.5, 2.0], [0.0, 3.0, 0.0, 0.0],
                    [2.0, 2.0, 2.0, 1.0]], np.float32)
    monkeypatch.setattr(TQ, "predict_class_t5", lambda *a, **k: _t(nll))
    monkeypatch.setattr(JB, "predict_class_t5",
                        lambda *a, **k: jnp.asarray(nll))
    jax_task, torch_task = _tasks(tiny, "VQATask", max_len=4)
    jax_task[0].answer_list = torch_task[0].answer_list = list("abcd")
    samples = _samples(tiny, 38, b=3)
    got = torch_task[0].valid_step(torch_task[1], samples)
    assert got == jax_task[0].valid_step(jax_task[1], samples)
    assert [r["answer"] for r in got] == ["b", "a", "d"]


def test_save_result_merges_shards_and_removes_duplicates(tmp_path):
    parts = [[{"question_id": 0, "answer": "a"}, {"question_id": 1,
                                                  "answer": "b"}],
             [{"question_id": 1, "answer": "b2"}, {"question_id": 2,
                                                   "answer": "c"}]]
    for side, save in (("jax", JQ.VQATask.save_result),
                       ("torch", TBase.BaseTask.save_result)):
        rd = str(tmp_path / side)
        for rank in (1, 0):
            final = save(parts[rank], rd, "val_vqa_result", "question_id",
                         rank=rank, world=2)
        assert final == str(tmp_path / side / "val_vqa_result.json")
    got = json.loads((tmp_path / "torch" / "val_vqa_result.json").read_text())
    assert got == json.loads(
        (tmp_path / "jax" / "val_vqa_result.json").read_text())
    assert [r["answer"] for r in got] == ["a", "b", "c"]
    # one process, no process group: rank 0 of 1
    final = TBase.BaseTask.save_result(parts[1], str(tmp_path / "one"), "r")
    assert json.loads(Path(final).read_text()) == parts[1]


@pytest.mark.parametrize("name", ["gqa", "okvqa"])
def test_setup_task_reads_the_eval_yaml_as_jax_does(name):
    path = (ROOT / "configs" / "projects" / "eval"
            / f"{name}_zeroshot_flant5xl_instruct_eval.yaml")
    cfg = yaml.safe_load(path.read_text())
    task_name = cfg["run"]["task"]
    jcls = jax_registry.get_task_class(task_name)
    tcls = registry.get_task_class(task_name)
    assert tcls.__name__ == jcls.__name__
    jt = jcls.setup_task(types.SimpleNamespace(run_cfg=cfg["run"],
                                               model_cfg=cfg["model"]))
    tt = tcls.setup_task(cfg, tokenizer=TTok.SimpleTokenizer())
    for attr in ("num_beams", "max_len", "min_len", "prompt",
                 "apply_lemmatizer", "speculative_gamma", "sample_id_key",
                 "answer_list"):
        assert getattr(tt, attr) == getattr(jt, attr), attr
    assert tt.apply_lemmatizer == (name == "okvqa")
    assert isinstance(tt.qformer_tokenizer, TTok.SimpleTokenizer)
    assert registry.get_task_class("aok_vqa") is TQ.VQATask


def test_unported_branches_raise(tiny):
    _, _, tm = tiny
    samples = _samples(tiny, 37, b=2)
    tok = TTok.SimpleTokenizer(96)
    not_t5 = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="item 8"):
        TQ.VQATask(tokenizer=tok).valid_step(not_t5, samples)
    ranker = TQ.GQATask(tokenizer=tok)
    ranker.answer_list = ["yes", "no"]
    with pytest.raises(NotImplementedError, match="ranking.*item 8"):
        ranker.valid_step(not_t5, samples)
    # the runner layer builds models and datasets from a Config; what it
    # cannot build yet raises with its item
    from vlm_compression_tpu_torch.common.config import Config

    with pytest.raises(NotImplementedError, match="not ported yet"):
        TBase.BaseTask().build_model(Config(tree={"model": {
            "arch": "blip2_opt"}}), device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        TBase.BaseTask().build_datasets(Config(tree={"datasets": {"c4": {}}}))
