"""Speculative decoding in the port vs the JAX package on the CPU, tiny fp32
widths, parameters and inputs from a numpy seed carried across by the weight
bridge (random masks, so the masked student and the dense teacher differ
and drafts are partly rejected).

Greedy: sequences equal JAX's token for token and equal the port's own
plain greedy decode under the target mode; ``rounds`` and ``committed``
equal JAX's — for bare T5 and LLaMA, batch-shared and per-row caches, γ 2
and 4, with a repetition penalty and a min length, a weak draft (another
seed), a smaller draft and an int8 draft; for both BLIP-2 wrappers, with
and without the int8 KV cache.  Per-row caches need no more rounds than
shared ones, and strictly fewer at JAX's pinned seed.  Sampling: torch's
generator cannot replay threefry draws, so the rejection rule is held by
its law — the first token's total variation under 0.03 against the target
distribution and over 0.1 against the draft's, and every token inside the
target's nucleus.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import F32, numpy_tree, port_config, random_masks
from test_torch_vicuna import _llama_pair, tiny_vicuna
from vlm_compression_tpu.models import blip2_t5_instruct as JB
from vlm_compression_tpu.models import blip2_vicuna_instruct as JBV
from vlm_compression_tpu.models import generation as JG
from vlm_compression_tpu.models import llama as JL
from vlm_compression_tpu.models import t5 as JT
from vlm_compression_tpu.ops.quant import quantize_params_tree
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as TBV
from vlm_compression_tpu_torch.models import generation as TG
from vlm_compression_tpu_torch.models import llama as TL
from vlm_compression_tpu_torch.models import t5 as TT
from vlm_compression_tpu_torch.models.bridge import load_jax_variables
from vlm_compression_tpu_torch.models.factory import set_kv_cache_
from vlm_compression_tpu_torch.ops.quant import quantize_model_int8_


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _t5_pair(seed, b=3, masks=True, **cfg_kw):
    """(jax module, jax variables, port module, ids, mask) of tiny fp32
    T5; row 1 of the prompt right-padded by 2."""
    rng = np.random.default_rng(seed)
    jcfg = JT.T5Config.tiny(**F32, **cfg_kw)
    jm = JT.T5ForConditionalGeneration(jcfg)
    ids = rng.integers(2, jcfg.vocab_size, (b, 7)).astype(np.int32)
    mask = np.ones((b, 7), np.int32)
    mask[1, -2:] = 0
    variables = numpy_tree(jm.init(jax.random.key(seed), _j(ids), _j(mask),
                                   jnp.zeros((b, 3), jnp.int32),
                                   mode="dense"))
    if masks:
        variables["masks"] = random_masks(variables["params"], rng)
    tm = TT.T5ForConditionalGeneration(port_config(jcfg, TT.T5Config),
                                       device="cpu")
    load_jax_variables(tm, variables)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm, ids, mask


def _assert_stats(got, want):
    assert got == {"rounds": int(want["rounds"]),
                   "committed": int(want["committed"])}


def _jcfg(**kw):
    return JG.GenerationConfig(eos_token_id=1, pad_token_id=0, **kw)


def _tcfg(**kw):
    return TG.GenerationConfig(eos_token_id=1, pad_token_id=0, **kw)


# ---------------------------------------------------------------- bare T5


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("gamma,rep,minlen", [(4, 1.0, 1), (2, 1.3, 4)])
def test_t5_self_speculative_matches_jax(gamma, rep, minlen, per_row):
    """The masked student drafts, the dense teacher verifies, one set of
    weights."""
    jm, jv, tm, ids, mask = _t5_pair(11, kv_cache_per_row=per_row)
    kw = dict(max_length=12, min_length=minlen, repetition_penalty=rep)
    want, _, wstats = JG.t5_speculative_generate(
        jm, jv, _j(ids), _j(mask), cfg=_jcfg(**kw), draft_mode="masked",
        target_mode="dense", gamma=gamma)
    got, lengths, stats = TG.t5_speculative_generate(
        tm, _t(ids), _t(mask), cfg=_tcfg(**kw), draft_mode="masked",
        target_mode="dense", gamma=gamma)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_stats(stats, wstats)
    greedy = TG.t5_generate(tm, _t(ids), _t(mask), cfg=_tcfg(**kw),
                            mode="dense")
    assert torch.equal(got, greedy)
    assert torch.equal(lengths, (greedy != 0).sum(-1))
    # partial acceptance: the student is not the teacher
    assert stats["committed"] < stats["rounds"] * 3 * gamma


def _draft(kind, jm, jv, tm, ids, mask, per_row):
    """(JAX draft kwargs, port draft model) of one draft tier."""
    if kind == "weak":          # the same shape, other weights
        _, dv, dm, _, _ = _t5_pair(99, kv_cache_per_row=per_row)
        return dict(draft_variables=dv), dm
    if kind == "int8":          # the teacher's weights in int8
        qv = dict(jv, params=quantize_params_tree(jv["params"]))
        return dict(draft_variables=qv), quantize_model_int8_(
            copy.deepcopy(tm))
    # a smaller T5 (1 layer, d_model 8) that encodes the prompt itself
    rng = np.random.default_rng(7)
    dcfg = JT.T5Config.tiny(d_model=8, d_kv=4, d_ff=16, num_layers=1,
                            num_decoder_layers=1, kv_cache_per_row=per_row,
                            **F32)
    dj = JT.T5ForConditionalGeneration(dcfg)
    dv = numpy_tree(dj.init(jax.random.key(7), _j(ids), _j(mask),
                            jnp.zeros((3, 3), jnp.int32), mode="dense"))
    dv["masks"] = random_masks(dv["params"], rng)
    dm = TT.T5ForConditionalGeneration(port_config(dcfg, TT.T5Config),
                                       device="cpu")
    load_jax_variables(dm, dv)
    return dict(draft_model=dj, draft_variables=jax.tree_util.tree_map(
        jnp.asarray, dv)), dm


@pytest.mark.parametrize("kind,per_row", [
    ("weak", False), ("weak", True), ("smaller", False), ("int8", False)])
def test_t5_draft_models_match_jax(kind, per_row):
    """JAX's ``draft_variables`` and ``draft_model`` tiers are the port's
    one ``draft_model`` argument: a same-shape draft decodes against the
    target's encoding, a smaller one runs its own encoder."""
    jm, jv, tm, ids, mask = _t5_pair(12, kv_cache_per_row=per_row)
    jkw, dm = _draft(kind, jm, jv, tm, ids, mask, per_row)
    gkw = dict(max_length=10)
    want, _, wstats = JG.t5_speculative_generate(
        jm, jv, _j(ids), _j(mask), cfg=_jcfg(**gkw), gamma=3,
        draft_mode="masked", target_mode="dense", **jkw)
    got, _, stats = TG.t5_speculative_generate(
        tm, _t(ids), _t(mask), cfg=_tcfg(**gkw), gamma=3,
        draft_mode="masked", target_mode="dense", draft_model=dm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_stats(stats, wstats)
    assert torch.equal(got, TG.t5_generate(tm, _t(ids), _t(mask),
                                           cfg=_tcfg(**gkw), mode="dense"))


def test_per_row_needs_strictly_fewer_rounds_as_in_jax():
    """JAX's pinned case: a noisy draft accepts differently per row, so
    shared caches (the batch minimum) need more rounds than per-row
    ones; both decode the target's greedy sequence, rounds equal JAX's."""
    cfg = JT.T5Config.tiny(**F32)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, cfg.vocab_size, (4, 6)).astype(np.int32)
    mask = np.ones((4, 6), np.int32)
    jm = JT.T5ForConditionalGeneration(cfg)
    params = jm.init(jax.random.PRNGKey(0), _j(ids), _j(mask),
                     jnp.zeros((4, 3), jnp.int32))
    noise = jax.tree_util.tree_map(
        lambda x: x + 0.02 * jax.random.normal(jax.random.key(1), x.shape,
                                               x.dtype), params["params"])
    gcfg = dict(max_length=16)
    rounds = {}
    for per_row in (False, True):
        c = dataclasses.replace(cfg, kv_cache_per_row=per_row)
        want, _, wstats = JG.t5_speculative_generate(
            JT.T5ForConditionalGeneration(c), params, _j(ids), _j(mask),
            cfg=_jcfg(**gcfg), gamma=3, draft_variables={"params": noise})
        tcfg = port_config(c, TT.T5Config)
        tm = TT.T5ForConditionalGeneration(tcfg, device="cpu")
        load_jax_variables(tm, numpy_tree(params))
        dm = TT.T5ForConditionalGeneration(tcfg, device="cpu")
        load_jax_variables(dm, numpy_tree({"params": noise}))
        got, _, stats = TG.t5_speculative_generate(
            tm, _t(ids), _t(mask), cfg=_tcfg(**gcfg), gamma=3,
            draft_model=dm)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _assert_stats(stats, wstats)
        rounds[per_row] = stats["rounds"]
    assert rounds[True] < rounds[False]


def test_draft_guards():
    _, _, tm, ids, mask = _t5_pair(13, masks=False)
    small = TT.T5ForConditionalGeneration(
        TT.T5Config.tiny(vocab_size=97, d_model=8, **F32), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        TG.t5_speculative_generate(tm, _t(ids), _t(mask), draft_model=small)
    per_row = TT.T5ForConditionalGeneration(
        TT.T5Config.tiny(kv_cache_per_row=True, **F32), device="cpu")
    with pytest.raises(ValueError, match="per_row"):
        TG.t5_speculative_generate(tm, _t(ids), _t(mask), draft_model=per_row)
    with pytest.raises(ValueError, match="input_ids"):
        TG.t5_speculative_generate(
            tm, inputs_embeds=tm.embed_tokens(_t(ids)),
            attention_mask=_t(mask), draft_model=TT.T5ForConditionalGeneration(
                TT.T5Config.tiny(d_model=8, **F32), device="cpu"))
    with pytest.raises(ValueError, match="gamma"):
        TG.t5_speculative_generate(tm, _t(ids), _t(mask), gamma=0)


# ------------------------------------------------------------------ LLaMA


def _small_llama(seed):
    dcfg = JL.LlamaConfig.tiny(hidden_size=8, intermediate_size=16,
                               num_layers=1, num_heads=2, **F32)
    dj = JL.LlamaForCausalLM(dcfg)
    dv = numpy_tree(dj.init(jax.random.key(seed), jnp.ones((2, 6),
                                                           jnp.int32)))
    dm = TL.LlamaForCausalLM(port_config(dcfg, TL.LlamaConfig), device="cpu")
    load_jax_variables(dm, dv)
    return dj, jax.tree_util.tree_map(jnp.asarray, dv), dm


@pytest.mark.parametrize("per_row,draft", [
    (False, "masked"), (True, "masked"), (False, "smaller")])
def test_causal_speculative_matches_jax(per_row, draft):
    """Left-padded prompts prime both caches (the rollback offset by the
    prefix, the verify chunk at consecutive rotary positions from each
    row's frontier)."""
    jm, jv, tm = _llama_pair(31)
    if per_row:
        jm = JL.LlamaForCausalLM(dataclasses.replace(jm.cfg,
                                                     kv_cache_per_row=True))
        set_kv_cache_(tm, per_row=True)
    jv = jax.tree_util.tree_map(jnp.asarray, jv)
    rng = np.random.default_rng(32)
    prompt = rng.integers(3, 96, (3, 6)).astype(np.int32)
    pmask = np.ones((3, 6), np.int32)
    pmask[1, :2] = 0
    pmask[2, :1] = 0
    kw = dict(max_length=9, eos_token_id=2, pad_token_id=0,
              repetition_penalty=1.2, min_length=3)
    jkw, tkw = {}, {}
    if draft == "smaller":
        dj, dv, dm = _small_llama(5)
        jkw = dict(draft_model=dj, draft_variables=dv, draft_mode="dense")
        tkw = dict(draft_model=dm, draft_mode="dense")
    want, _, wstats = JG.causal_speculative_generate(
        jm, jv, _j(prompt), _j(pmask), cfg=JG.GenerationConfig(**kw),
        gamma=3, target_mode="dense", **jkw)
    got, _, stats = TG.causal_speculative_generate(
        tm, _t(prompt), _t(pmask), cfg=TG.GenerationConfig(**kw), gamma=3,
        target_mode="dense", **tkw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    _assert_stats(stats, wstats)
    # the target's own greedy decode over the same primed prefix
    emb = tm.embed_tokens(_t(prompt[:, :-1]))
    step, cache = TL.make_causal_step(tm, emb, _t(pmask[:, :-1]),
                                      mode="dense", max_decode_len=9)
    start = _t(prompt[:, -1])
    greedy, _ = TG.greedy_generate(
        TG.with_start(step, start), cache, 3,
        TG.GenerationConfig(decoder_start_token_id=-1, **kw))
    greedy[:, 0] = start
    assert torch.equal(got, greedy)


# --------------------------------------------------------- BLIP-2 wrappers


@pytest.fixture(scope="module")
def blip_t5():
    from test_torch_models import tiny_blip

    jm, variables, tm, batch = tiny_blip(seed=41, masks=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm, batch


@pytest.mark.parametrize("per_row,int8", [
    (False, False), (True, False), (False, True), (True, True)])
def test_generate_t5_speculative_matches_jax(blip_t5, per_row, int8):
    jm, jv, tm, batch = blip_t5
    jm = JB.Blip2T5Instruct(dataclasses.replace(jm.cfg, t5=dataclasses.replace(
        jm.cfg.t5, kv_cache_per_row=per_row, kv_cache_int8=int8)))
    set_kv_cache_(tm, int8=int8, per_row=per_row)
    try:
        args = [batch[k] for k in ("image", "input_ids", "attention_mask",
                                   "qformer_input_ids",
                                   "qformer_attention_mask")]
        kw = dict(num_beams=1, max_length=8, min_length=2)
        want = JB.generate_t5(jm, jv, *map(_j, args),
                              gen_cfg=_jcfg(**kw), llm_mode="dense",
                              draft_llm_mode="masked", speculative_gamma=3)
        stats = {}
        got = TB.generate_t5(tm, *map(_t, args), gen_cfg=_tcfg(**kw),
                             llm_mode="dense", draft_llm_mode="masked",
                             speculative_gamma=3, stats=stats)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        greedy = TB.generate_t5(tm, *map(_t, args), gen_cfg=_tcfg(**kw),
                                llm_mode="dense")
        assert torch.equal(got, greedy)
        assert set(stats) == {"rounds", "committed"} and stats["rounds"] >= 2
    finally:
        set_kv_cache_(tm)


@pytest.fixture(scope="module")
def blip_vicuna():
    jm, variables, tm, _ = tiny_vicuna(seed=42)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm


@pytest.mark.parametrize("per_row,int8", [(False, False), (True, True)])
def test_generate_vicuna_speculative_matches_jax(blip_vicuna, per_row, int8):
    """Each cache primed under its own mode; -1 stands for each row's last
    prompt token and never reaches the embedding."""
    jm, jv, tm = blip_vicuna
    jm = JBV.Blip2VicunaInstruct(dataclasses.replace(
        jm.cfg, llm=dataclasses.replace(jm.cfg.llm, kv_cache_per_row=per_row,
                                        kv_cache_int8=int8)))
    set_kv_cache_(tm, int8=int8, per_row=per_row)
    try:
        rng = np.random.default_rng(43)
        img = jm.cfg.vit.img_size
        image = rng.standard_normal((3, img, img, 3)).astype(np.float32)
        ids = rng.integers(3, 96, (3, 5)).astype(np.int32)
        mask = np.ones((3, 5), np.int32)
        mask[1, :1] = 0
        mask[2, :2] = 0
        ids = np.where(mask == 1, ids, 0).astype(np.int32)
        ids[0, 0] = ids[1, 1] = ids[2, 2] = 1
        q_ids = rng.integers(2, jm.cfg.qformer.vocab_size,
                             (3, 4)).astype(np.int32)
        q_mask = np.ones((3, 4), np.int32)
        args = (image, ids, mask, q_ids, q_mask)
        kw = dict(num_beams=1, max_length=7, min_length=1, eos_token_id=2,
                  pad_token_id=0)
        want = JBV.generate_vicuna(jm, jv, *map(_j, args),
                                   gen_cfg=JG.GenerationConfig(**kw),
                                   llm_mode="dense", draft_llm_mode="masked",
                                   speculative_gamma=3)
        got = TBV.generate_vicuna(tm, *map(_t, args),
                                  gen_cfg=TG.GenerationConfig(**kw),
                                  llm_mode="dense", draft_llm_mode="masked",
                                  speculative_gamma=3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        greedy = TBV.generate_vicuna(tm, *map(_t, args),
                                     gen_cfg=TG.GenerationConfig(**kw),
                                     llm_mode="dense")
        assert torch.equal(got, greedy)
        np.testing.assert_array_equal(got[:, 0].numpy(), ids[:, -1])
    finally:
        set_kv_cache_(tm)


# ---------------------------------------------------------------- sampling


def _const_step(logits):
    """A step giving the same logits at every position; its cache holds
    only the index that the rollback sets."""
    def step(tokens, cache):
        b, n = tokens.shape
        kv = cache["layers"][0]["self"]
        kv["index"] = kv["index"] + n
        return logits[None, None].expand(b, n, -1), cache
    return step


def _const_cache():
    return {"layers": [{"self": {"index": 0}}]}


def test_sampling_mode_matches_the_target_distribution():
    """8192 rows, γ 1: the first committed token's histogram is the
    target's softmax(logits / τ), not the draft's."""
    V, B = 8, 8192
    rng = np.random.default_rng(42)
    t_logits = _t((rng.standard_normal(V) * 1.5).astype(np.float32))
    d_logits = _t((rng.standard_normal(V) * 1.5).astype(np.float32))
    cfg = _tcfg(max_length=2, do_sample=True, temperature=0.7, top_p=1.0)
    cfg = dataclasses.replace(cfg, eos_token_id=V + 5)
    seqs, _, stats = TG.speculative_generate(
        _const_step(d_logits), _const_cache(), _const_step(t_logits),
        _const_cache(), B, cfg, gamma=1,
        generator=torch.Generator().manual_seed(7))
    hist = np.bincount(seqs[:, 1].numpy(), minlength=V) / B
    tv = 0.5 * np.abs(hist - torch.softmax(t_logits / 0.7, -1).numpy()).sum()
    tv_d = 0.5 * np.abs(hist - torch.softmax(d_logits / 0.7, -1).numpy()).sum()
    assert tv < 0.03, (tv, hist)
    assert tv_d > 0.1, "draft and target too similar for this test"
    assert stats == {"rounds": 1, "committed": B}


def test_sampling_mode_stays_in_the_target_nucleus():
    """γ 3, top-p 0.7, several rounds: every emitted token lies in the
    target's top-p nucleus at temperature τ."""
    V, B = 16, 512
    rng = np.random.default_rng(3)
    t_logits = _t((rng.standard_normal(V) * 2.0).astype(np.float32))
    d_logits = _t((rng.standard_normal(V) * 2.0).astype(np.float32))
    tau, topp = 0.8, 0.7
    cfg = dataclasses.replace(
        _tcfg(max_length=8, do_sample=True, temperature=tau, top_p=topp),
        eos_token_id=V + 5)
    seqs, _, stats = TG.speculative_generate(
        _const_step(d_logits), _const_cache(), _const_step(t_logits),
        _const_cache(), B, cfg, gamma=3,
        generator=torch.Generator().manual_seed(11))
    allowed = TG.top_p_filter(t_logits[None] / tau, topp)[0] > -1e6
    assert bool(allowed[seqs[:, 1:].long()].all())
    assert stats["rounds"] >= 3 and stats["committed"] == 7 * B


def test_sampling_mode_with_draft_equal_to_target_accepts_everything():
    """p = q: every proposal is accepted, so a round commits γ tokens."""
    V, B = 12, 64
    logits = _t(np.random.default_rng(5).standard_normal(V)
                .astype(np.float32))
    cfg = dataclasses.replace(_tcfg(max_length=9, do_sample=True),
                              eos_token_id=V + 5)
    _, _, stats = TG.speculative_generate(
        _const_step(logits), _const_cache(), _const_step(logits),
        _const_cache(), B, cfg, gamma=4,
        generator=torch.Generator().manual_seed(1))
    assert stats == {"rounds": 2, "committed": 8 * B}
