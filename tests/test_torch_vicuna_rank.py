"""Candidate ranking on InstructBLIP-Vicuna in the port vs the JAX package
on the CPU, tiny fp32 widths, parameters and inputs from a numpy seed
carried across by the weight bridge (random masks).

Tolerances: ``predict_class_vicuna``'s (b, C) summed NLLs atol = rtol =
1e-4 of JAX's; the rank task's answers, metrics and result file equal;
the port's rows in chunks (1, 3 and 7 rows at a time) bit-equal to one
pass over all of them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vicuna import _samples, _tokenizers, tiny_vicuna
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.models import blip2_vicuna_instruct as JBV
from vlm_compression_tpu.tasks import vqa as JVQA
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as TBV
from vlm_compression_tpu_torch.tasks import vqa as TVQA

TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT = "Question: {} Short answer:"
ANSWERS = ["yes", "no", "two dogs", "the red car", "left", "sky",
           "how many are there"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def tiny():
    jm, variables, tm, _ = tiny_vicuna(seed=61)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm


def _rank_inputs(cfg, seed, b=3):
    """Image, right-padded prompts (as the rank step encodes them), the
    candidates (C, L) right-padded, the Q-Former's ids."""
    toks = _tokenizers(TTok, cfg)
    samples = _samples(cfg, seed, b=b)
    prompts = [PROMPT.format(q) for q in samples["text_input"]]
    ids, mask = TTok.batch_encode(toks["tokenizer"], prompts, 128)
    c_ids, c_mask = TTok.batch_encode(toks["tokenizer"], ANSWERS, 10)
    q_ids, q_mask = TTok.batch_encode(toks["qformer_tokenizer"], prompts,
                                      128)
    assert (mask == 0).any() and (c_mask == 0).any()
    return samples["image"], ids, mask, c_ids, c_mask, q_ids, q_mask


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_predict_class_vicuna_matches_jax(tiny, mode):
    jm, variables, tm = tiny
    args = _rank_inputs(jm.cfg, 62)
    modes = dict(vit_mode=mode, llm_mode=mode, qformer_mode=mode)
    want = np.asarray(JBV.predict_class_vicuna(
        jm, variables, *map(_j, args), **modes))
    got = TBV.predict_class_vicuna(tm, *map(_t, args), **modes)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (3, len(ANSWERS))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.ptp(want, axis=-1).min() > 1e-2


@pytest.mark.parametrize("rows", [1, 3, 7])
def test_chunked_rows_equal_one_pass(tiny, rows):
    """The b·C rows go through the LM in chunks: each row's NLL is its own
    whatever the chunk, bit for bit."""
    jm, _, tm = tiny
    args = [_t(a) for a in _rank_inputs(jm.cfg, 63)]
    whole = TBV.predict_class_vicuna(tm, *args, rows_per_chunk=3 * 7)
    chunked = TBV.predict_class_vicuna(tm, *args, rows_per_chunk=rows)
    assert torch.equal(chunked, whole)
    # the default chunk holds every row at these widths
    assert torch.equal(TBV.predict_class_vicuna(tm, *args), whole)


@pytest.mark.parametrize("cls_name", ["GQATask", "VQATask"])
def test_rank_task_on_vicuna_matches_jax(tiny, tmp_path, cls_name):
    jm, variables, tm = tiny
    kw = dict(max_len=10, prompt=PROMPT)
    jt = getattr(JVQA, cls_name)(**kw, **_tokenizers(JTok, jm.cfg))
    tt = getattr(TVQA, cls_name)(**kw, **_tokenizers(TTok, jm.cfg))
    jt.answer_list = tt.answer_list = ANSWERS
    samples = _samples(jm.cfg, 64)
    first = tt.evaluation(tm, [samples])
    picked = [r["answer"] for r in first]
    assert set(picked) <= set(ANSWERS)
    samples = dict(samples, answers=[
        [a] * (10 if i % 2 == 0 else 3) + ["never produced"] * (
            0 if i % 2 == 0 else 7) for i, a in enumerate(picked)])
    want = jt.evaluation(FlaxModel(jm, variables), [samples])
    got = tt.evaluation(tm, [samples])
    assert got == want
    metrics = []
    for side, task, res in (("jax", jt, want), ("torch", tt, got)):
        rd = tmp_path / side / "result"
        rd.mkdir(parents=True)
        metrics.append(task.after_evaluation(res, split_name="val",
                                             result_dir=str(rd)))
    assert metrics[0] == metrics[1]
    assert (tmp_path / "torch" / "result/val_vqa_result.json").read_text() \
        == (tmp_path / "jax" / "result/val_vqa_result.json").read_text()


def test_rank_task_answers_are_the_argmin_of_a_direct_call(tiny):
    jm, _, tm = tiny
    task = TVQA.GQATask(max_len=10, prompt=PROMPT,
                        **_tokenizers(TTok, jm.cfg))
    task.answer_list = ANSWERS
    samples = _samples(jm.cfg, 65)
    records = task.valid_step(tm, samples)
    image, ids, mask, c_ids, c_mask, q_ids, q_mask = _rank_inputs(jm.cfg, 65,
                                                                  b=4)
    nll = TBV.predict_class_vicuna(tm, *map(_t, (image, ids, mask, c_ids,
                                                 c_mask, q_ids, q_mask)))
    assert [r["answer"] for r in records] == [
        ANSWERS[i] for i in torch.argmin(nll, dim=-1).tolist()]


def test_predict_class_vicuna_ranks_only_vicuna(tiny):
    _, _, tm = tiny
    with pytest.raises(TypeError, match="InstructBLIP-Vicuna"):
        TBV.predict_class_vicuna(torch.nn.Linear(2, 2), *[None] * 5)
    assert isinstance(tm, TBV.Blip2VicunaInstruct)
