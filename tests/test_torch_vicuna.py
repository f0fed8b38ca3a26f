"""InstructBLIP-Vicuna in the port vs the JAX package on the CPU, tiny fp32
widths, parameters and inputs from a numpy seed carried across by the weight
bridge.

Tolerances: ``LlamaRMSNorm`` and the rotary embedding atol = rtol = 1e-6;
``LlamaForCausalLM`` logits (dense and masked, random masks, ragged left
and right padding), the primed cached decode's logits per step, the
composition's ``encode_image`` and loss atol = rtol = 1e-5; generated
tokens (beam 1 and 3) equal; the Wanda, SparseGPT and DSnoT keep-masks of
``blipt5_*_pruner`` with ``t5_model_prefix="llm_model"`` (chained behind
the ViT sweep and not) bit for bit, SparseGPT's updated kernels at the
tolerance ``tests/test_torch_sparsegpt.py`` states; the GQA / OK-VQA tasks'
answers, metrics, result file and ``evaluate.txt`` line equal; the
factory's configs field for field.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import F32, numpy_tree, port_config, random_masks
from test_torch_pipeline import _copy_spine
from test_torch_sparsegpt import W_TOL, _seeded_biases
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.models import blip2_vicuna_instruct as JBV
from vlm_compression_tpu.models import eva_vit as JV
from vlm_compression_tpu.models import factory as JF
from vlm_compression_tpu.models import kvcache as JKV
from vlm_compression_tpu.models import llama as JL
from vlm_compression_tpu.models import qformer as JQ
from vlm_compression_tpu.models.generation import (
    GenerationConfig as JGenerationConfig,
)
from vlm_compression_tpu.tasks import vqa as JVQA
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.compression.pruners.towers import (
    BlipT5PrunerBase,
)
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as TBV
from vlm_compression_tpu_torch.models import eva_vit as TV
from vlm_compression_tpu_torch.models import factory as TF
from vlm_compression_tpu_torch.models import kvcache as TKV
from vlm_compression_tpu_torch.models import llama as TL
from vlm_compression_tpu_torch.models import qformer as TQ
from vlm_compression_tpu_torch.models.bridge import (
    export_masks,
    flatten,
    load_jax_variables,
)
from vlm_compression_tpu_torch.models.generation import GenerationConfig
from vlm_compression_tpu_torch.tasks import vqa as TVQA

TOL = dict(atol=1e-5, rtol=1e-5)
TIGHT = dict(atol=1e-6, rtol=1e-6)
PROMPT = "Question: {} Short answer:"


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# ------------------------------------------------------------------- tower


def _llama_pair(seed, masks=True):
    """(jax module, jax variables, port module) of tiny fp32 LLaMA, the
    norm scales drawn away from 1."""
    rng = np.random.default_rng(seed)
    jcfg = JL.LlamaConfig.tiny(**F32)
    jm = JL.LlamaForCausalLM(jcfg)
    ids = jnp.ones((2, 6), jnp.int32)
    variables = numpy_tree(jm.init(jax.random.key(seed), ids, mode="dense"))
    params = jax.tree_util.tree_map(
        lambda v: v + (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
        if v.ndim == 1 else v, variables["params"])
    variables = {"params": params}
    if masks:
        variables["masks"] = random_masks(params, rng)
    tm = TL.LlamaForCausalLM(port_config(jcfg, TL.LlamaConfig), device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _ragged(rng, b, n, vocab, left=True):
    """ids (b, n) and a mask with b different pad lengths (0 … b − 1)."""
    ids = rng.integers(3, vocab, (b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    for i in range(b):
        if i:
            if left:
                mask[i, :i] = 0
            else:
                mask[i, n - i:] = 0
    return np.where(mask == 1, ids, 0).astype(np.int32), mask


@pytest.mark.parametrize("shape", [(2, 5, 16), (3, 1, 8)])
def test_rmsnorm_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    scale = rng.standard_normal(shape[-1:]).astype(np.float32)
    jm = JL.LlamaRMSNorm(1e-6)
    want = jm.apply({"params": {"scale": _j(scale)}}, _j(x))
    tm = TL.LlamaRMSNorm(shape[-1], 1e-6, "cpu")
    tm.scale.copy_(_t(scale))
    np.testing.assert_allclose(tm(_t(x)).numpy(), np.asarray(want), **TIGHT)


def test_rotary_tables_match_jax():
    jc, js = JL.rotary_tables(128, 2048, 10000.0)
    tc, ts = TL.rotary_tables(128, 2048, 10000.0)
    assert tc.dtype == ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("ragged", [False, True])
def test_apply_rotary_matches_jax(ragged):
    rng = np.random.default_rng(2)
    b, n, h, d = 3, 7, 2, 8
    q = rng.standard_normal((b, n, h, d)).astype(np.float32)
    k = rng.standard_normal((b, n, h, d)).astype(np.float32)
    if ragged:
        _, mask = _ragged(rng, b, n, 96)
        pos = np.maximum(np.cumsum(mask, -1) - 1, 0).astype(np.int32)
    else:
        pos = np.broadcast_to(np.arange(n), (b, n)).astype(np.int32)
    jc, js = JL.rotary_tables(d, 64, 10000.0)
    wq, wk = JL.apply_rotary(_j(q), _j(k), jc, js, _j(pos))
    tc, ts = TL.rotary_tables(d, 64, 10000.0)
    gq, gk = TL.apply_rotary(_t(q), _t(k), tc, ts, _t(pos).long())
    np.testing.assert_allclose(gq.numpy(), np.asarray(wq), **TIGHT)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), **TIGHT)


@pytest.mark.parametrize("padding", ["none", "left", "right"])
@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_llama_logits_match_jax(mode, padding):
    jm, variables, tm = _llama_pair(3)
    rng = np.random.default_rng(4)
    ids, mask = _ragged(rng, 4, 9, 96, left=padding == "left")
    if padding == "none":
        mask = np.ones_like(mask)
    want = jm.apply(variables, _j(ids), _j(mask), mode=mode)
    got = tm(_t(ids), _t(mask), mode=mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


def test_llama_loss_matches_jax():
    jm, variables, tm = _llama_pair(5)
    rng = np.random.default_rng(6)
    ids, mask = _ragged(rng, 3, 8, 96, left=False)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    want = jm.apply(variables, _j(ids), _j(mask), labels=_j(labels))
    got = tm(_t(ids), _t(mask), labels=_t(labels))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)


@pytest.mark.parametrize("cur,n,max_len,padded", [
    (0, 7, 11, True), (7, 1, 11, True), (3, 4, 9, False)])
def test_step_visibility_of_a_multi_slot_write_matches_jax(cur, n, max_len,
                                                           padded):
    """The prime writes n slots in one call: query cur + i sees the slots
    j ≤ cur + i, on top of the cache's padding bias."""
    prev = None
    if padded:
        keep = np.ones((2, max_len), bool)
        keep[1, :2] = False
        prev = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None]
    want = np.asarray(JKV.step_visibility_mask(
        cur, n, max_len, None if prev is None else _j(prev)))
    got = TKV.step_visibility_mask(cur, n, max_len,
                                   None if prev is None else _t(prev))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_primed_cached_decode_matches_jax(mode):
    """The prefix (left-padded by 0, 1 and 2 tokens in one batch) primes
    the cache in one call; four steps then decode one token each, the
    batch repeated per beam (2) as beam search runs it: the logits of
    every step equal JAX's ``make_causal_step``'s."""
    jm, variables, tm = _llama_pair(7)
    rng = np.random.default_rng(8)
    ids, mask = _ragged(rng, 3, 6, 96)
    # one step at the batch, then three with each row repeated per beam
    # and the beams fed different tokens, as beam search runs them
    steps = [rng.integers(3, 96, (3, 1)).astype(np.int32)]
    steps += [rng.integers(3, 96, (6, 1)).astype(np.int32) for _ in range(3)]
    jemb = jm.apply(variables, _j(ids), method=jm.embed_tokens)
    jstep, jcache = JL.make_causal_step(jm, variables, jemb, _j(mask),
                                        mode=mode, max_decode_len=4)
    temb = tm.embed_tokens(_t(ids))
    tstep, tcache = TL.make_causal_step(tm, temb, _t(mask), mode=mode,
                                        max_decode_len=4)
    for t, tok in enumerate(steps):
        want, jcache = jstep(_j(tok), jcache)
        got, tcache = tstep(_t(tok), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {t}")
        if t == 0:
            for layer in tcache["layers"]:
                for key in ("key", "value"):
                    layer["self"][key] = \
                        layer["self"][key].repeat_interleave(2, dim=0)
            jcache = jax.tree_util.tree_map(
                lambda x: jnp.repeat(x, 2, axis=0) if x.ndim else x, jcache)
    assert tcache["layers"][0]["self"]["index"] == ids.shape[1] + 4


def test_cached_decode_of_a_prefix_matches_the_full_forward():
    """Port against itself: with no padding, the primed steps give the
    full forward's logits at those positions."""
    _, _, tm = _llama_pair(9)
    ids = _t(np.random.default_rng(10).integers(3, 96, (2, 8))
             .astype(np.int32))
    full = tm(ids)
    step, cache = TL.make_causal_step(tm, tm.embed_tokens(ids[:, :5]), None,
                                      max_decode_len=3)
    got = torch.cat([step(ids[:, t:t + 1], cache)[0] for t in range(5, 8)],
                    dim=1)
    torch.testing.assert_close(got, full[:, 5:8], **TOL)


# ------------------------------------------------------------- composition


def tiny_vicuna_configs():
    jcfg = JBV.Blip2VicunaInstructConfig.tiny(
        vit=JV.EvaViTConfig.tiny(**F32),
        qformer=JQ.QFormerConfig.tiny(dtype="float32"),
        llm=JL.LlamaConfig.tiny(**F32))
    tcfg = TBV.Blip2VicunaInstructConfig(
        vit=port_config(jcfg.vit, TV.EvaViTConfig),
        qformer=port_config(jcfg.qformer, TQ.QFormerConfig),
        llm=port_config(jcfg.llm, TL.LlamaConfig))
    return jcfg, tcfg


def vicuna_batch(rng, cfg, b=2, txt=6):
    """Packed prompt+answer (right-padded), labels on the answer only."""
    img = cfg.vit.img_size
    ids, mask = _ragged(rng, b, txt, cfg.llm.vocab_size, left=False)
    ids[:, 0] = cfg.llm.bos_token_id
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :txt // 2] = -100
    qmask = np.ones((b, txt), np.int32)
    qmask[-1, -1] = 0
    return dict(
        image=rng.standard_normal((b, img, img, 3)).astype(np.float32),
        text_input_ids=ids, text_attention_mask=mask, labels=labels,
        qformer_input_ids=rng.integers(
            2, cfg.qformer.vocab_size, (b, txt)).astype(np.int32),
        qformer_attention_mask=qmask)


def tiny_vicuna(seed=0, masks=True):
    """(jax module, jax variables as numpy, port module, batch)."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = tiny_vicuna_configs()
    batch = vicuna_batch(rng, jcfg)
    jm = JBV.Blip2VicunaInstruct(jcfg)
    variables = numpy_tree(jm.init(
        jax.random.key(seed), **{k: _j(v) for k, v in batch.items()},
        vit_mode="dense", llm_mode="dense", qformer_mode="dense"))
    if masks:
        variables = dict(variables,
                         masks=random_masks(variables["params"], rng))
    tm = TBV.Blip2VicunaInstruct(tcfg, device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm, batch


@pytest.fixture(scope="module")
def tiny():
    jm, variables, tm, batch = tiny_vicuna(seed=21)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm, batch


@pytest.mark.parametrize("video", [False, True])
def test_encode_image_matches_jax(tiny, video):
    jm, variables, tm, batch = tiny
    rng = np.random.default_rng(22)
    img = jm.cfg.vit.img_size
    shape = (2, 3, img, img, 3) if video else (2, img, img, 3)
    image = rng.standard_normal(shape).astype(np.float32)
    args = (batch["qformer_input_ids"], batch["qformer_attention_mask"])
    want = jm.apply(variables, _j(image), "masked", *map(_j, args), "masked",
                    method=JBV.Blip2VicunaInstruct.encode_image)
    got = tm.encode_image(_t(image), "masked", *map(_t, args), "masked")
    nq = jm.cfg.qformer.num_query_tokens
    assert tuple(got.shape) == (2, (3 if video else 1) * nq,
                                jm.cfg.llm.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_vicuna_loss_matches_jax(tiny, mode):
    jm, variables, tm, batch = tiny
    modes = dict(vit_mode=mode, llm_mode=mode, qformer_mode=mode)
    want = jm.apply(variables, **{k: _j(v) for k, v in batch.items()},
                    **modes)
    got = tm(**{k: _t(v) for k, v in batch.items()}, **modes)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)


def _prompts(rng, cfg, b=3, n=5):
    """Left-padded prompts, BOS first, pad lengths 0, 1, 2."""
    ids, mask = _ragged(rng, b, n, cfg.llm.vocab_size)
    for i in range(b):
        ids[i, i] = cfg.llm.bos_token_id
    return ids, mask


@pytest.mark.parametrize("beams,min_length", [(1, 1), (3, 1), (3, 4)])
def test_generate_vicuna_matches_jax(tiny, beams, min_length):
    jm, variables, tm, _ = tiny
    rng = np.random.default_rng(23 + beams)
    cfg = jm.cfg
    img = cfg.vit.img_size
    image = rng.standard_normal((3, img, img, 3)).astype(np.float32)
    ids, mask = _prompts(rng, cfg)
    q_ids = rng.integers(2, cfg.qformer.vocab_size, (3, 4)).astype(np.int32)
    q_mask = np.ones((3, 4), np.int32)
    kw = dict(max_length=6, min_length=min_length, num_beams=beams,
              eos_token_id=cfg.llm.eos_token_id,
              pad_token_id=cfg.llm.pad_token_id)
    want = np.asarray(JBV.generate_vicuna(
        jm, variables, _j(image), _j(ids), _j(mask), _j(q_ids), _j(q_mask),
        gen_cfg=JGenerationConfig(**kw)))
    got = TBV.generate_vicuna(tm, _t(image), _t(ids), _t(mask), _t(q_ids),
                              _t(q_mask), gen_cfg=GenerationConfig(**kw))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:, 0], ids[:, -1])


def test_unported_vicuna_paths_raise(tiny):
    """``use_remat`` raised until it was ported: LLaMA with every block
    checkpointed gives JAX's remat'd loss and logits, and the same loss,
    logits and gradients as without it, bit for bit."""
    jm, variables, tm, _ = tiny
    rng = np.random.default_rng(23)
    ids = rng.integers(3, jm.cfg.llm.vocab_size, (2, 7)).astype(np.int32)
    mask = np.ones((2, 7), np.int32)
    mask[0, :2] = 0
    sub = {c: t["llm_model"] for c, t in variables.items()
           if isinstance(t, dict) and "llm_model" in t}
    jl = JL.LlamaForCausalLM(dataclasses.replace(jm.cfg.llm, use_remat=True))
    want = jl.apply(sub, _j(ids), _j(mask), labels=_j(ids))
    outs = []
    for remat in (False, True):
        lm = TL.LlamaForCausalLM(dataclasses.replace(tm.llm_model.cfg,
                                                     use_remat=remat),
                                 device="cpu")
        load_jax_variables(lm, jax.tree_util.tree_map(np.asarray, sub))
        with torch.enable_grad():
            out = lm(_t(ids), _t(mask), labels=_t(ids))
            out["loss"].backward()
        outs.append((out, {n: p.grad for n, p in lm.named_parameters()}))
    (plain, g0), (remat, g1) = outs
    for key in ("loss", "logits"):
        assert torch.equal(plain[key], remat[key])
        np.testing.assert_allclose(remat[key].detach().numpy(),
                                   np.asarray(want[key]), **TOL)
    assert set(g0) == set(g1) and all(torch.equal(g0[n], g1[n]) for n in g0)


@pytest.mark.parametrize("knob", ["kv_cache_int8", "kv_cache_per_row"])
def test_llama_takes_the_kv_cache_knobs(knob):
    """The cache forms are ported: the tower builds, and its cache has the
    form's buffers (int8 codes and scales; a (b,) index)."""
    lm = TL.LlamaForCausalLM(TL.LlamaConfig.tiny(**{knob: True}, **F32),
                             device="cpu")
    kv = lm.init_cache(2, 4, torch.float32, "cpu")["layers"][0]["self"]
    if knob == "kv_cache_int8":
        assert kv["key"].dtype == torch.int8 and "value_scale" in kv
    else:
        assert tuple(kv["index"].shape) == (2,) and kv["bound"] == 0


@pytest.mark.parametrize("cls_name,beams,per_row,int8", [
    ("GQATask", 2, False, False), ("GQATask", 1, True, False),
    ("VQATask", 1, True, True)],
    ids=["gqa_beams_to_greedy", "gqa_per_row", "okvqa_per_row_int8"])
def test_speculative_vqa_tasks_on_vicuna_match_jax(tiny, cls_name, beams,
                                                   per_row, int8, caplog,
                                                   monkeypatch):
    """``speculative_gamma``: the masked student drafts, the dense teacher
    verifies, beams give way to greedy with a warning; the answers equal
    the JAX task's and the dense greedy decode's."""
    jm, variables, tm, _ = tiny
    jm = JBV.Blip2VicunaInstruct(dataclasses.replace(
        jm.cfg, llm=dataclasses.replace(jm.cfg.llm, kv_cache_per_row=per_row,
                                        kv_cache_int8=int8)))
    TF.set_kv_cache_(tm, int8=int8, per_row=per_row)
    try:
        kw = dict(num_beams=beams, max_len=4, min_len=1, prompt=PROMPT,
                  speculative_gamma=2)
        jt = getattr(JVQA, cls_name)(**kw, **_tokenizers(JTok, jm.cfg))
        tt = getattr(TVQA, cls_name)(**kw, **_tokenizers(TTok, jm.cfg))
        samples = _samples(jm.cfg, 47)
        with caplog.at_level("WARNING"):
            got = tt.evaluation(tm, [samples])
        assert ("replaces num_beams" in caplog.text) == (beams > 1)
        assert got == jt.evaluation(FlaxModel(jm, variables), [samples])
        dense = getattr(TVQA, cls_name)(**dict(kw, num_beams=1,
                                               speculative_gamma=0),
                                        **_tokenizers(TTok, jm.cfg))
        teacher = TVQA.generate_vicuna
        monkeypatch.setattr(TVQA, "generate_vicuna", lambda *a, **k: teacher(
            *a, **dict(k, llm_mode="dense")))
        assert got == dense.evaluation(tm, [samples])
        assert tt.spec_stats["rows"] == len(samples["question_id"])
        assert tt.spec_stats["rounds"] >= 2
    finally:
        TF.set_kv_cache_(tm)


# ----------------------------------------------------------------- pruners

SPECS = dict(vit_prune_spec="2-0.5-1.0-1.0", t5_prune_spec="2-0.5-1.0-1.0",
             t5_model_prefix="llm_model")


def _calib(seed, n, bs, txt=6):
    rng = np.random.default_rng(seed)
    jcfg, _ = tiny_vicuna_configs()
    return [vicuna_batch(rng, jcfg, b=bs, txt=txt) for _ in range(n)]


def _pruned_paths(params):
    out = []
    for tower in ("visual_encoder", "llm_model"):
        for bname, bparams in params[tower].items():
            if bname.startswith("blocks_"):
                for path, _ in flatten(bparams).items():
                    if path[-1] == "kernel":
                        out.append((tower, bname) + path[:-1])
    return sorted(out)


def _run_both(name, seed, batches, lora_model, biases=False, **kw):
    jm, variables, tm, _ = tiny_vicuna(seed=seed, masks=False)
    if biases:
        variables = _seeded_biases(variables, tm, seed)
    specs = dict(SPECS, num_samples=sum(len(b["image"]) for b in batches),
                 **kw)
    jres, _ = jax_load_pruner(
        name, FlaxModel(jm, _copy_spine(variables)),
        [{k: _j(v) for k, v in b.items()} for b in batches],
        **specs).prune(lora_model=lora_model)
    tres, _ = load_pruner(name, tm, [{k: _t(v) for k, v in b.items()}
                                     for b in batches],
                          **specs).prune(lora_model=lora_model)
    assert tres is tm
    pruned = _pruned_paths(jres.variables["params"])
    assert len(pruned) == 2 * 4 + 2 * 7
    return jres.variables, tres, pruned


def _assert_masks_equal(jvars, tres, pruned, density=True):
    got = export_masks(tres)
    want = {path[:-1]: np.asarray(m)
            for path, m in flatten(jvars["masks"]).items()}
    assert set(got) == set(want) == set(pruned)
    for path in pruned:
        np.testing.assert_array_equal(got[path], want[path],
                                      err_msg="/".join(path))
        if density:
            assert abs(got[path].mean() - 0.5) < 0.1


def _assert_kernels_like_jax(jvars, tres, pruned, kernel_tol=None):
    """The pruned weights zeroed where JAX zeroed them (and, with
    ``kernel_tol``, the kept ones updated alike)."""
    params = flatten(jvars["params"])
    tparams = dict(tres.named_parameters())
    for path in pruned:
        want = np.asarray(params[path + ("kernel",)])
        got = tparams[".".join(path + ("kernel",))].numpy()
        np.testing.assert_array_equal(got == 0, want == 0,
                                      err_msg="/".join(path))
        assert abs((got == 0).mean() - 0.5) < 0.1
        if kernel_tol is not None:
            np.testing.assert_allclose(got, want, **kernel_tol,
                                       err_msg="/".join(path))


@pytest.mark.parametrize("lora_model", [True, False])
def test_blipt5_wanda_pruner_on_vicuna_matches_jax(lora_model):
    """lora_model=True: the LLM stem runs the ViT dense; False: the sweeps
    chain, the LLM stem fed by the pruned ViT's replayed features, and the
    pruned weights are zeroed with no mask kept."""
    jvars, tres, pruned = _run_both("blipt5_wanda_pruner", 31,
                                    _calib(32, 2, 4), lora_model)
    if lora_model:
        _assert_masks_equal(jvars, tres, pruned)
    else:
        assert export_masks(tres) == {}
        _assert_kernels_like_jax(jvars, tres, pruned)


@pytest.mark.parametrize("lora_model", [True, False])
def test_blipt5_sparsegpt_pruner_on_vicuna_matches_jax(lora_model):
    """8 batches of 8 samples: every Hessian of full rank (the LLaMA MLP's
    down_proj takes 32 inputs), every LayerNorm bias seeded."""
    jvars, tres, pruned = _run_both("blipt5_sparsegpt_pruner", 33,
                                    _calib(34, 8, 8), lora_model,
                                    biases=True)
    if lora_model:
        _assert_masks_equal(jvars, tres, pruned)
    else:
        assert export_masks(tres) == {}
    _assert_kernels_like_jax(jvars, tres, pruned, W_TOL)


@pytest.mark.parametrize("kw,lora_model", [
    ({}, True), (dict(prune_n=2, prune_m=4), True), ({}, False)],
    ids=["unstructured", "2:4", "unstructured_chained"])
def test_blipt5_dsnot_pruner_on_vicuna_matches_jax(kw, lora_model):
    jvars, tres, pruned = _run_both("blipt5_dsnot_pruner", 35,
                                    _calib(36, 2, 4), lora_model,
                                    update_threshold=0.01, **kw)
    # the refinement's masks keep other densities than 0.5 at these
    # widths, JAX's as the port's
    if lora_model:
        _assert_masks_equal(jvars, tres, pruned, density=False)
        return
    assert export_masks(tres) == {}
    params = flatten(jvars["params"])
    tparams = dict(tres.named_parameters())
    for path in pruned:
        want = np.asarray(params[path + ("kernel",)]) == 0
        got = tparams[".".join(path + ("kernel",))].numpy() == 0
        np.testing.assert_array_equal(got, want, err_msg="/".join(path))


def test_blipt5_mag_pruner_on_vicuna_matches_jax():
    """The global magnitude pruner over the ViT and ``llm_model`` kernels:
    no calibration data, the threshold over both towers."""
    jvars, tres, pruned = _run_both("blipt5_mag_pruner", 37,
                                    _calib(38, 1, 2), True)
    _assert_masks_equal(jvars, tres, pruned)


def test_the_llm_sweep_covers_every_llama_linear():
    """The decoder-only branch sweeps ``llm_model.blocks_*`` in order and
    no other linear (not the LM head, not llm_proj)."""
    _, _, tm, _ = tiny_vicuna(seed=39, masks=False)
    batches = [{k: _t(v) for k, v in b.items()} for b in _calib(40, 1, 2)]
    load_pruner("blipt5_wanda_pruner", tm, batches,
                **dict(SPECS, vit_prune_spec=None, num_samples=2)).prune()
    names = sorted(".".join(p) for p in export_masks(tm))
    assert names == sorted(
        f"llm_model.blocks_{i}.{lin}" for i in range(2)
        for lin in ("self_attn.q_proj", "self_attn.k_proj", "self_attn.v_proj",
                    "self_attn.o_proj", "mlp.gate_proj", "mlp.up_proj",
                    "mlp.down_proj"))
    assert issubclass(type(load_pruner("blipt5_wanda_pruner", tm, batches,
                                       **SPECS)), BlipT5PrunerBase)


# ------------------------------------------------------------------- tasks


def _samples(cfg, seed, b=4):
    rng = np.random.default_rng(seed)
    img = cfg.vit.img_size
    words = ["what", "is", "the", "man", "holding", "color", "dog", "how",
             "many", "cars", "are", "there", "left", "sky"]
    return {
        "image": rng.standard_normal((b, img, img, 3)).astype(np.float32),
        # ragged lengths: the prompts left-pad by different amounts
        "text_input": [" ".join(rng.choice(words, 1 + i % 4)) + "?"
                       for i in range(b)],
        "question_id": list(range(b)),
        "instance_id": list(range(b)),
    }


def _tokenizers(mod, cfg):
    """The LLaMA ids (pad 0, BOS 1, EOS 2) and the Q-Former's own."""
    return dict(tokenizer=mod.SimpleTokenizer(cfg.llm.vocab_size,
                                              eos_token_id=2, bos_token_id=1),
                qformer_tokenizer=mod.SimpleTokenizer(cfg.qformer.vocab_size))


@pytest.mark.parametrize("cls_name,beams,lemmatize", [
    ("GQATask", 1, False), ("GQATask", 2, False), ("VQATask", 2, True)],
    ids=["gqa_beam1", "gqa_beam2", "okvqa_beam2"])
def test_vqa_tasks_on_vicuna_match_jax(tiny, tmp_path, cls_name, beams,
                                       lemmatize):
    jm, variables, tm, _ = tiny
    kw = dict(num_beams=beams, max_len=4, min_len=1, prompt=PROMPT,
              apply_lemmatizer=lemmatize)
    jt = getattr(JVQA, cls_name)(**kw, **_tokenizers(JTok, jm.cfg))
    tt = getattr(TVQA, cls_name)(**kw, **_tokenizers(TTok, jm.cfg))
    samples = _samples(jm.cfg, 41 + beams)
    first = tt.evaluation(tm, [samples])
    answers = [r["answer"] for r in first]
    samples = dict(samples, answers=[
        [a] * (10 if i % 2 == 0 else 3) + ["never produced"] * (
            0 if i % 2 == 0 else 7) for i, a in enumerate(answers)])
    want = jt.evaluation(FlaxModel(jm, variables), [samples])
    got = tt.evaluation(tm, [samples])
    assert got == want
    assert [r["answer"] for r in got] == answers
    metrics = []
    for side, task, res in (("jax", jt, want), ("torch", tt, got)):
        rd = tmp_path / side / "result"
        rd.mkdir(parents=True)
        metrics.append(task.after_evaluation(res, split_name="val",
                                             result_dir=str(rd)))
    assert metrics[0] == metrics[1]
    for name in ("result/val_vqa_result.json", "evaluate.txt"):
        assert (tmp_path / "torch" / name).read_text() == \
            (tmp_path / "jax" / name).read_text()


def test_vqa_task_answers_are_a_direct_generate(tiny):
    """The task's answers: ``generate_vicuna`` on the left-padded prompts
    (BOS first), decoded after the seed column and cut at the LLaMA EOS."""
    jm, _, tm, _ = tiny
    toks = _tokenizers(TTok, jm.cfg)
    task = TVQA.GQATask(num_beams=2, max_len=4, prompt=PROMPT, **toks)
    samples = _samples(jm.cfg, 45)
    records = task.valid_step(tm, samples)
    prompts = [PROMPT.format(q) for q in samples["text_input"]]
    ids, mask = TTok.batch_encode(toks["tokenizer"], prompts, 128,
                                  left_pad=True, add_bos=True)
    assert (mask[:, 0] == 0).any() and (ids[mask == 1][:1] == 1).all()
    q_ids, q_mask = TTok.batch_encode(toks["qformer_tokenizer"], prompts, 128)
    seqs = TBV.generate_vicuna(
        tm, _t(samples["image"]), _t(ids), _t(mask), _t(q_ids), _t(q_mask),
        gen_cfg=GenerationConfig(num_beams=2, max_length=5, min_length=1,
                                 eos_token_id=2))
    direct = []
    for row in seqs[:, 1:].tolist():
        row = row[:row.index(2)] if 2 in row else row
        direct.append(toks["tokenizer"].decode(row).strip())
    assert [r["answer"] for r in records] == direct


# ----------------------------------------------------------------- factory


# the JAX knobs the port's tower configs leave out (none since remat)
NOT_PORTED_KNOBS = set()


def _assert_fields_equal(tcfg, jcfg):
    """Every field of the port's config equals JAX's; JAX's other fields
    are the not-ported knobs, off."""
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert set(t) == {"vit", "qformer", "llm", "max_txt_len",
                      "max_output_txt_len"}
    for key, tv in t.items():
        if not isinstance(tv, dict):
            assert tv == j[key], key
            continue
        assert set(tv) <= set(j[key]), key
        assert {f: j[key][f] for f in tv} == tv, key
        extra = set(j[key]) - set(tv)
        assert extra <= NOT_PORTED_KNOBS and not any(
            j[key][f] for f in extra), key


@pytest.mark.parametrize("size,tune_opt", [("vicuna7b", ""),
                                           ("vicuna7b", "LVQ"),
                                           ("vicuna13b", "L")])
def test_factory_vicuna_configs_match_jax(size, tune_opt):
    node = dict(arch="blip2_vicuna_instruct", model_type=size,
                tune_opt=tune_opt, lora_r_v=4, lora_r_l=8, lora_r_q=2)
    jarch, jcfg = JF.build_model_config(node)
    tarch, tcfg = TF.build_model_config(node)
    assert jarch == tarch == "blip2_vicuna_instruct"
    assert isinstance(tcfg, TBV.Blip2VicunaInstructConfig)
    _assert_fields_equal(tcfg, jcfg)
    assert tcfg.llm.head_dim == jcfg.llm.head_dim == 128


@pytest.mark.parametrize("knobs", [("kv_cache_int8",), ("kv_cache_per_row",),
                                   ("kv_cache_int8", "kv_cache_per_row")])
def test_factory_kv_cache_knobs_match_jax(knobs):
    """The model config's KV-cache knobs reach every tower that carries
    them, as JAX's ``set_field_everywhere`` does."""
    node = dict(arch="blip2_vicuna_instruct", model_type="vicuna7b",
                **{k: True for k in knobs})
    _, jcfg = JF.build_model_config(node)
    _, tcfg = TF.build_model_config(node)
    _assert_fields_equal(tcfg, jcfg)
    for knob in ("kv_cache_int8", "kv_cache_per_row"):
        assert getattr(tcfg.llm, knob) == (knob in knobs)


def test_factory_builds_a_seeded_tiny_vicuna():
    node = dict(arch="blip2_vicuna_instruct", tiny=True, tune_opt="L",
                lora_r_l=4, amp=False)
    model = TF.build_model(node, seed=3, device="cpu")
    assert isinstance(model, TBV.Blip2VicunaInstruct)
    assert model.cfg.llm.dtype == "float32"
    lm = model.llm_model
    assert lm.blocks_0.self_attn.q_proj.lora_rank == 4
    assert float(lm.blocks_0.input_ln.scale.min()) == 1.0
    again = TF.build_model(node, seed=3, device="cpu")
    for (n1, p1), (_, p2) in zip(model.named_parameters(),
                                 again.named_parameters()):
        assert torch.equal(p1, p2), n1


def test_vicuna_entry_points_need_a_device_without_gpu(monkeypatch):
    """With no GPU and no ``device``, the composition and the factory
    raise; they never carry on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TBV.Blip2VicunaInstruct(TBV.Blip2VicunaInstructConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TF.build_model(dict(arch="blip2_vicuna_instruct", tiny=True))
    model = TBV.Blip2VicunaInstruct(TBV.Blip2VicunaInstructConfig.tiny(),
                                    device="cpu")
    assert model.device == torch.device("cpu")
