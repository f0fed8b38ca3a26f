"""BLIP-2 OPT in the port vs the JAX package on the CPU, tiny fp32 widths,
parameters and inputs from a numpy seed carried across by the weight
bridge.

Tolerances: ``OPTForCausalLM`` logits (dense and masked, random masks,
left and right padding), its loss, the primed cached decode's logits per
step, ``Blip2OPT.encode_image`` and its loss atol = rtol = 1e-5;
``generate_opt`` tokens equal at beams 1 and 3 and at a binding
``min_length``, speculative (γ 2, greedy) equal with and without the int8
and per-row caches; the int8 cache's codes and scales JAX's
``quantize_kv`` of the k/v written, bit for bit (within one code step of
JAX's own cache, whose float k/v differ by fp32 rounding); the
VQA / GQA tasks' answers, metrics, result file and ``evaluate.txt`` line
equal; the ``vit_wanda_pruner`` keep-masks of the OPT model's ViT bit for
bit.  Sampling (rejection at γ 2) is held by its seeded reproducibility
and by a draft equal to the target accepting every proposal: torch's
generator cannot replay threefry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import F32, numpy_tree, port_config, random_masks
from test_torch_pipeline import _copy_spine
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.datasets import tokenization as JTok
from vlm_compression_tpu.models import blip2_opt as JBO
from vlm_compression_tpu.models import eva_vit as JV
from vlm_compression_tpu.models import llama as JL
from vlm_compression_tpu.models import opt as JO
from vlm_compression_tpu.models import qformer as JQ
from vlm_compression_tpu.models.generation import (
    GenerationConfig as JGenerationConfig,
)
from vlm_compression_tpu.tasks import vqa as JVQA
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.datasets import tokenization as TTok
from vlm_compression_tpu_torch.models import blip2_opt as TBO
from vlm_compression_tpu_torch.models import eva_vit as TV
from vlm_compression_tpu_torch.models import llama as TL
from vlm_compression_tpu_torch.models import opt as TO
from vlm_compression_tpu_torch.models import qformer as TQ
from vlm_compression_tpu_torch.models.bridge import (
    export_masks,
    flatten,
    load_jax_variables,
)
from vlm_compression_tpu_torch.models.factory import set_kv_cache_
from vlm_compression_tpu_torch.models.generation import GenerationConfig
from vlm_compression_tpu_torch.tasks import vqa as TVQA

TOL = dict(atol=1e-5, rtol=1e-5)
PROMPT = "Question: {} Short answer:"
# OPT's ids: pad 1, BOS = EOS = 2
OPT_IDS = dict(eos_token_id=2, pad_token_id=1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _nudged(params, rng):
    """Every 1-D leaf (biases, LayerNorm scales) drawn away from its
    init, so the biases and norms take part."""
    return jax.tree_util.tree_map(
        lambda v: v + (0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
        if v.ndim == 1 else v, params)


# ------------------------------------------------------------------- tower


def _opt_pair(seed, masks=True, **cfg_kw):
    """(jax module, jax variables, port module) of tiny fp32 OPT."""
    rng = np.random.default_rng(seed)
    jcfg = JO.OPTConfig.tiny(**F32, **cfg_kw)
    jm = JO.OPTForCausalLM(jcfg)
    ids = jnp.ones((2, 6), jnp.int32)
    variables = numpy_tree(jm.init(jax.random.key(seed), ids, mode="dense"))
    variables = {"params": _nudged(variables["params"], rng)}
    if masks:
        variables["masks"] = random_masks(variables["params"], rng)
    tm = TO.OPTForCausalLM(port_config(jcfg, TO.OPTConfig), device="cpu")
    load_jax_variables(tm, variables)
    return jm, variables, tm


def _ragged(rng, b, n, vocab, left=True):
    """ids (b, n) and a mask with b different pad lengths (0 … b − 1)."""
    ids = rng.integers(3, vocab, (b, n)).astype(np.int32)
    mask = np.ones((b, n), np.int32)
    for i in range(1, b):
        if left:
            mask[i, :i] = 0
        else:
            mask[i, n - i:] = 0
    return np.where(mask == 1, ids, 1).astype(np.int32), mask


def test_opt_configs_match_jax():
    for name in ("opt_2_7b", "opt_6_7b", "tiny"):
        want = getattr(JO.OPTConfig, name)()
        got = getattr(TO.OPTConfig, name)()
        assert dataclasses.asdict(got) == dataclasses.asdict(want), name
        assert got.head_dim == want.head_dim
    assert TO.OPTConfig.opt_6_7b().head_dim == 128
    assert TO.OPTConfig.opt_2_7b().head_dim == 80


@pytest.mark.parametrize("padding", ["none", "left", "right"])
@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_opt_logits_match_jax(mode, padding):
    jm, variables, tm = _opt_pair(3)
    rng = np.random.default_rng(4)
    ids, mask = _ragged(rng, 4, 9, 96, left=padding == "left")
    if padding == "none":
        mask = np.ones_like(mask)
    want = jm.apply(variables, _j(ids), _j(mask), mode=mode)
    got = tm(_t(ids), _t(mask), mode=mode)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(np.abs(np.asarray(want)).max()) > 0.1


def test_opt_loss_matches_jax():
    jm, variables, tm = _opt_pair(5)
    rng = np.random.default_rng(6)
    ids, mask = _ragged(rng, 3, 8, 96, left=False)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    want = jm.apply(variables, _j(ids), _j(mask), labels=_j(labels))
    got = tm(_t(ids), _t(mask), labels=_t(labels))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), **TOL)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **TOL)


def test_positions_carry_the_offset_and_count_valid_tokens():
    """Position p reads row p + 2 of ``embed_positions`` (rows 0 and 1 are
    never read); a left-padded row's valid tokens take positions 0, 1, …,
    so its logits there are the unpadded row's."""
    _, _, tm = _opt_pair(7, masks=False)
    rng = np.random.default_rng(8)
    ids = _t(rng.integers(3, 96, (1, 6)).astype(np.int32))
    want = tm(ids)
    table = tm.embed_positions.embedding
    saved = table.clone()
    table[:2] = 100.0
    torch.testing.assert_close(tm(ids), want, rtol=0, atol=0)
    table[2] += 1.0
    assert not torch.allclose(tm(ids), want)
    table.copy_(saved)
    padded = torch.cat([torch.ones((1, 3), dtype=ids.dtype), ids], dim=1)
    pmask = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1, 1]], dtype=torch.int32)
    torch.testing.assert_close(tm(padded, pmask)[:, 3:], want, **TOL)


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_primed_cached_decode_matches_jax(mode):
    """The prefix (left-padded by 0, 1 and 2 tokens) primes the cache in
    one call through ``llama.make_causal_step``; four steps then decode one
    token each, the batch repeated per beam after the first: every step's
    logits equal JAX's."""
    jm, variables, tm = _opt_pair(9)
    rng = np.random.default_rng(10)
    ids, mask = _ragged(rng, 3, 6, 96)
    steps = [rng.integers(3, 96, (3, 1)).astype(np.int32)]
    steps += [rng.integers(3, 96, (6, 1)).astype(np.int32) for _ in range(3)]
    jemb = jm.apply(variables, _j(ids), method=jm.embed_tokens)
    jstep, jcache = JL.make_causal_step(jm, variables, jemb, _j(mask),
                                        mode=mode, max_decode_len=4)
    tstep, tcache = TL.make_causal_step(tm, tm.embed_tokens(_t(ids)),
                                        _t(mask), mode=mode, max_decode_len=4)
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
    _, _, tm = _opt_pair(11)
    ids = _t(np.random.default_rng(12).integers(3, 96, (2, 8))
             .astype(np.int32))
    full = tm(ids)
    step, cache = TL.make_causal_step(tm, tm.embed_tokens(ids[:, :5]), None,
                                      max_decode_len=3)
    got = torch.cat([step(ids[:, t:t + 1], cache)[0] for t in range(5, 8)],
                    dim=1)
    torch.testing.assert_close(got, full[:, 5:8], **TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_int8_cache_codes_are_bit_equal_to_jax(per_row, monkeypatch):
    """The int8 cache after the prime and two steps: each layer's codes and
    scales are JAX's ``quantize_kv`` of the k/v the port wrote, bit for
    bit; against JAX's own int8 cache (whose float k/v differ from the
    port's by fp32 rounding) the codes move by at most one step and the
    scales agree within 1e-6; the logits within the tolerance."""
    from vlm_compression_tpu.models import kvcache as JKV

    jm, variables, tm = _opt_pair(13)
    jm = JO.OPTForCausalLM(dataclasses.replace(
        jm.cfg, kv_cache_int8=True, kv_cache_per_row=per_row))
    set_kv_cache_(tm, int8=True, per_row=per_row)
    written = {}
    cache_kv = TO.cache_kv

    def recording(cache, k, v):
        written.setdefault(id(cache), []).append((k.clone(), v.clone()))
        return cache_kv(cache, k, v)

    monkeypatch.setattr(TO, "cache_kv", recording)
    rng = np.random.default_rng(14)
    ids, mask = _ragged(rng, 2, 5, 96)
    jemb = jm.apply(variables, _j(ids), method=jm.embed_tokens)
    jstep, jcache = JL.make_causal_step(jm, variables, jemb, _j(mask),
                                        max_decode_len=3)
    try:
        tstep, tcache = TL.make_causal_step(tm, tm.embed_tokens(_t(ids)),
                                            _t(mask), max_decode_len=3)
        for _ in range(2):
            tok = rng.integers(3, 96, (2, 1)).astype(np.int32)
            want, jcache = jstep(_j(tok), jcache)
            got, tcache = tstep(_t(tok), tcache)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    finally:
        set_kv_cache_(tm)
    for i, layer in enumerate(tcache["layers"]):
        kv = layer["self"]
        jl = jcache[f"blocks_{i}"]["self_attn"]
        assert kv["key"].dtype == torch.int8
        calls = written[id(kv)]
        for j, key in enumerate(("key", "value")):
            # the written slots: the 5-token prime and the two steps
            fed = torch.cat([c[j] for c in calls], dim=1)
            assert fed.shape[1] == 7
            codes, scales = JKV.quantize_kv(_j(fed.numpy()))
            np.testing.assert_array_equal(kv[key][:, :7].numpy(),
                                          np.asarray(codes))
            np.testing.assert_array_equal(kv[f"{key}_scale"][:, :7].numpy(),
                                          np.asarray(scales))
            step = np.abs(kv[key].numpy().astype(np.int32)
                          - np.asarray(jl[f"cached_{key}"], np.int32))
            assert step.max() <= 1
            np.testing.assert_allclose(kv[f"{key}_scale"].numpy(),
                                       np.asarray(jl[f"cached_{key}_scale"]),
                                       rtol=1e-6, atol=0)
        np.testing.assert_array_equal(np.asarray(kv["index"]),
                                      np.asarray(jl["cache_index"]))


def test_load_jax_variables_is_strict_over_the_opt_tree():
    jm, variables, tm = _opt_pair(15, masks=False)
    params = dict(variables["params"])
    params.pop("final_norm")
    with pytest.raises(KeyError, match="final_norm"):
        load_jax_variables(tm, {"params": params}, strict=True)
    extra = dict(variables["params"], stray={"kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="stray"):
        load_jax_variables(tm, {"params": extra})
    names = {n for n, _ in tm.named_parameters()}
    assert {"embed_tokens.embedding", "embed_positions.embedding",
            "blocks_0.self_attn_ln.scale", "blocks_1.final_ln.bias",
            "blocks_0.self_attn.q_proj.bias", "blocks_0.fc1.kernel",
            "final_norm.scale", "lm_head.kernel"} <= names
    assert "lm_head.bias" not in names
    assert tuple(tm.embed_positions.embedding.shape) == (64 + 2, 16)


# ------------------------------------------------------------- composition


def tiny_opt_configs():
    jcfg = JBO.Blip2OPTConfig.tiny(
        vit=JV.EvaViTConfig.tiny(**F32),
        qformer=JQ.QFormerConfig.tiny(dtype="float32"),
        opt=JO.OPTConfig.tiny(**F32))
    tcfg = TBO.Blip2OPTConfig(
        vit=port_config(jcfg.vit, TV.EvaViTConfig),
        qformer=port_config(jcfg.qformer, TQ.QFormerConfig),
        opt=port_config(jcfg.opt, TO.OPTConfig))
    return jcfg, tcfg


def opt_batch(rng, cfg, b=2, txt=6):
    """Prompt + answer (right-padded), labels on the answer only."""
    img = cfg.vit.img_size
    ids, mask = _ragged(rng, b, txt, cfg.opt.vocab_size, left=False)
    ids[:, 0] = cfg.opt.bos_token_id
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :txt // 2] = -100
    return dict(
        image=rng.standard_normal((b, img, img, 3)).astype(np.float32),
        text_input_ids=ids, text_attention_mask=mask, labels=labels)


def tiny_opt(seed=0, masks=True):
    """(jax module, jax variables as numpy, port module, batch)."""
    rng = np.random.default_rng(seed)
    jcfg, tcfg = tiny_opt_configs()
    batch = opt_batch(rng, jcfg)
    jm = JBO.Blip2OPT(jcfg)
    variables = numpy_tree(jm.init(
        jax.random.key(seed), **{k: _j(v) for k, v in batch.items()},
        vit_mode="dense", llm_mode="dense", qformer_mode="dense"))
    variables = {"params": _nudged(variables["params"], rng)}
    if masks:
        variables["masks"] = random_masks(variables["params"], rng)
    tm = TBO.Blip2OPT(tcfg, device="cpu")
    load_jax_variables(tm, variables, strict=True)
    return jm, variables, tm, batch


@pytest.fixture(scope="module")
def tiny():
    jm, variables, tm, batch = tiny_opt(seed=21)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm, batch


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_encode_image_matches_jax(tiny, mode):
    jm, variables, tm, _ = tiny
    rng = np.random.default_rng(22)
    img = jm.cfg.vit.img_size
    image = rng.standard_normal((3, img, img, 3)).astype(np.float32)
    want = jm.apply(variables, _j(image), mode, mode,
                    method=JBO.Blip2OPT.encode_image)
    got = tm.encode_image(_t(image), mode, mode)
    assert tuple(got.shape) == (3, jm.cfg.qformer.num_query_tokens,
                                jm.cfg.opt.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_blip2_opt_loss_matches_jax(tiny, mode):
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
    ids, mask = _ragged(rng, b, n, cfg.opt.vocab_size)
    for i in range(b):
        ids[i, i] = cfg.opt.bos_token_id
    return ids, mask


def _gen_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    img = cfg.vit.img_size
    image = rng.standard_normal((3, img, img, 3)).astype(np.float32)
    return (image,) + _prompts(rng, cfg)


@pytest.mark.parametrize("beams,min_length", [(1, 1), (3, 1), (3, 4)])
def test_generate_opt_matches_jax(tiny, beams, min_length):
    jm, variables, tm, _ = tiny
    image, ids, mask = _gen_inputs(jm.cfg, 23 + beams + min_length)
    kw = dict(max_length=6, min_length=min_length, num_beams=beams,
              **OPT_IDS)
    want = np.asarray(JBO.generate_opt(
        jm, variables, _j(image), _j(ids), _j(mask),
        gen_cfg=JGenerationConfig(**kw)))
    got = TBO.generate_opt(tm, _t(image), _t(ids), _t(mask),
                           gen_cfg=GenerationConfig(**kw))
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[:, 0], ids[:, -1])


def test_min_length_binds_in_generate_opt(tiny):
    """With EOS the top logit at every step (the final norm's output pinned
    to its bias of ones, EOS's column of the head the largest), EOS comes
    at position min_length and no earlier, in the port as in JAX."""
    jm, variables, tm, _ = tiny
    image, ids, mask = _gen_inputs(jm.cfg, 29)
    eos = OPT_IDS["eos_token_id"]
    params = jax.tree_util.tree_map(np.array, variables["params"])
    opt = params["opt_model"]
    opt["final_norm"]["scale"][:] = 0.0
    opt["final_norm"]["bias"][:] = 1.0
    opt["lm_head"]["kernel"][:, eos] = np.abs(opt["lm_head"]["kernel"]).max()
    jv = dict(variables, params=jax.tree_util.tree_map(jnp.asarray, params))
    saved = {k: v.clone() for k, v in tm.opt_model.state_dict().items()}
    tm.opt_model.final_norm.scale.copy_(_t(opt["final_norm"]["scale"]))
    tm.opt_model.final_norm.bias.copy_(_t(opt["final_norm"]["bias"]))
    tm.opt_model.lm_head.kernel.copy_(_t(opt["lm_head"]["kernel"]))
    try:
        kw = dict(max_length=7, min_length=4, num_beams=1, **OPT_IDS)
        want = np.asarray(JBO.generate_opt(
            jm, jv, _j(image), _j(ids), _j(mask), gen_cfg=JGenerationConfig(
                **kw), llm_mode="dense"))
        got = TBO.generate_opt(tm, _t(image), _t(ids), _t(mask),
                               gen_cfg=GenerationConfig(**kw),
                               llm_mode="dense").numpy()
        np.testing.assert_array_equal(got, want)
        first_eos = [list(r[1:]).index(eos) + 1 for r in got]
        assert first_eos == [4, 4, 4]
    finally:
        tm.opt_model.load_state_dict(saved)


def _with_cache(jm, tm, int8, per_row):
    set_kv_cache_(tm, int8=int8, per_row=per_row)
    return JBO.Blip2OPT(dataclasses.replace(jm.cfg, opt=dataclasses.replace(
        jm.cfg.opt, kv_cache_int8=int8, kv_cache_per_row=per_row)))


@pytest.mark.parametrize("per_row,int8", [
    (False, False), (True, False), (False, True), (True, True)])
def test_generate_opt_speculative_matches_jax(tiny, per_row, int8):
    """γ 2, the masked student drafting and the dense teacher verifying:
    tokens equal JAX's and the port's own dense greedy decode."""
    jm, variables, tm, _ = tiny
    jm = _with_cache(jm, tm, int8, per_row)
    try:
        image, ids, mask = _gen_inputs(jm.cfg, 31)
        kw = dict(num_beams=1, max_length=7, min_length=1, **OPT_IDS)
        want = JBO.generate_opt(jm, variables, _j(image), _j(ids), _j(mask),
                                gen_cfg=JGenerationConfig(**kw),
                                llm_mode="dense", draft_llm_mode="masked",
                                speculative_gamma=2)
        stats = {}
        got = TBO.generate_opt(tm, _t(image), _t(ids), _t(mask),
                               gen_cfg=GenerationConfig(**kw),
                               llm_mode="dense", draft_llm_mode="masked",
                               speculative_gamma=2, stats=stats)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        greedy = TBO.generate_opt(tm, _t(image), _t(ids), _t(mask),
                                  gen_cfg=GenerationConfig(**kw),
                                  llm_mode="dense")
        assert torch.equal(got, greedy)
        assert set(stats) == {"rounds", "committed"} and stats["rounds"] >= 2
    finally:
        set_kv_cache_(tm)


def test_generate_opt_speculative_sampling(tiny):
    """Rejection sampling at γ 2: one seed gives one sequence; a draft
    equal to the target (both dense) accepts every proposal, so each
    round commits γ tokens."""
    jm, _, tm, _ = tiny
    image, ids, mask = _gen_inputs(jm.cfg, 33)
    eos = jm.cfg.opt.vocab_size + 5           # never emitted: full rounds
    cfg = GenerationConfig(num_beams=1, max_length=9, do_sample=True,
                           top_p=1.0, eos_token_id=eos, pad_token_id=1)

    def run(seed, draft):
        stats = {}
        seqs = TBO.generate_opt(
            tm, _t(image), _t(ids), _t(mask), gen_cfg=cfg, llm_mode="dense",
            draft_llm_mode=draft, speculative_gamma=2, stats=stats,
            generator=torch.Generator().manual_seed(seed))
        return seqs, stats

    a, _ = run(5, "masked")
    b, _ = run(5, "masked")
    assert torch.equal(a, b)
    assert bool(((a >= 0) & (a < jm.cfg.opt.vocab_size)).all())
    _, stats = run(6, "dense")
    assert stats == {"rounds": 4, "committed": 3 * 8}


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
    """OPT's ids (pad 1, BOS = EOS = 2) and the Q-Former's own (encoded by
    the task, read by no OPT model)."""
    return dict(tokenizer=mod.SimpleTokenizer(cfg.opt.vocab_size,
                                              pad_token_id=1, eos_token_id=2,
                                              bos_token_id=2),
                qformer_tokenizer=mod.SimpleTokenizer(cfg.qformer.vocab_size))


@pytest.mark.parametrize("cls_name,beams,lemmatize", [
    ("GQATask", 1, False), ("GQATask", 3, False), ("VQATask", 3, True)],
    ids=["gqa_beam1", "gqa_beam3", "okvqa_beam3"])
def test_vqa_tasks_on_opt_match_jax(tiny, tmp_path, cls_name, beams,
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


def test_speculative_gqa_on_opt_matches_jax(tiny, caplog):
    jm, variables, tm, _ = tiny
    kw = dict(num_beams=3, max_len=4, min_len=1, prompt=PROMPT,
              speculative_gamma=2)
    jt = JVQA.GQATask(**kw, **_tokenizers(JTok, jm.cfg))
    tt = TVQA.GQATask(**kw, **_tokenizers(TTok, jm.cfg))
    samples = _samples(jm.cfg, 47)
    with caplog.at_level("WARNING"):
        got = tt.evaluation(tm, [samples])
    assert "replaces num_beams" in caplog.text
    assert got == jt.evaluation(FlaxModel(jm, variables), [samples])
    assert tt.spec_stats["rows"] == len(samples["question_id"])


def test_vqa_task_answers_are_a_direct_generate_opt(tiny):
    """The task's answers: ``generate_opt`` on the left-padded prompts (BOS
    first; no Q-Former text), decoded after the seed column, cut at EOS."""
    jm, _, tm, _ = tiny
    toks = _tokenizers(TTok, jm.cfg)
    task = TVQA.GQATask(num_beams=3, max_len=4, prompt=PROMPT, **toks)
    samples = _samples(jm.cfg, 45)
    records = task.valid_step(tm, samples)
    prompts = [PROMPT.format(q) for q in samples["text_input"]]
    ids, mask = TTok.batch_encode(toks["tokenizer"], prompts, 128,
                                  left_pad=True, add_bos=True)
    assert (mask[:, 0] == 0).any() and (ids[mask == 0] == 1).all()
    seqs = TBO.generate_opt(
        tm, _t(samples["image"]), _t(ids), _t(mask),
        gen_cfg=GenerationConfig(num_beams=3, max_length=5, min_length=1,
                                 **OPT_IDS))
    direct = []
    for row in seqs[:, 1:].tolist():
        row = row[:row.index(2)] if 2 in row else row
        direct.append(toks["tokenizer"].decode(row).strip())
    assert [r["answer"] for r in records] == direct


def test_opt_gets_no_ranking_of_its_own(tiny):
    """Ranking sends every model but T5 to ``predict_class_vicuna``, as the
    JAX package does; that ranks on InstructBLIP-Vicuna alone."""
    jm, _, tm, _ = tiny
    task = TVQA.GQATask(prompt=PROMPT, **_tokenizers(TTok, jm.cfg))
    task.answer_list = ["yes", "no"]
    with pytest.raises(TypeError, match="Blip2OPT"):
        task.valid_step(tm, _samples(jm.cfg, 49, b=2))


# ----------------------------------------------------------------- pruners


@pytest.mark.parametrize("lora_model", [True, False])
def test_vit_wanda_on_the_opt_models_vit_matches_jax(tiny, lora_model):
    """``vit_wanda_pruner`` on Blip2OPT's bare ViT (JAX's pruners sweep no
    OPT tower): the keep-masks, or the zeroed kernels, bit for bit; the
    pruned model's prefix within the tolerance."""
    jm, variables, _, _ = tiny
    params = numpy_tree(variables["params"])
    rng = np.random.default_rng(51)
    img = jm.cfg.vit.img_size
    batches = [{"image": rng.standard_normal((4, img, img, 3))
                .astype(np.float32)} for _ in range(2)]
    spec = dict(vit_prune_spec="2-0.5-1.0-1.0", num_samples=8)
    jres, _ = jax_load_pruner(
        "vit_wanda_pruner",
        FlaxModel(JV.EvaViT(jm.cfg.vit),
                  _copy_spine({"params": params["visual_encoder"]})),
        [{"image": jnp.asarray(b["image"])} for b in batches],
        **spec).prune(lora_model=lora_model)
    _, tcfg = tiny_opt_configs()
    tm = TBO.Blip2OPT(tcfg, device="cpu")
    load_jax_variables(tm, {"params": params}, strict=True)
    load_pruner("vit_wanda_pruner", tm.visual_encoder,
                [{"image": _t(b["image"])} for b in batches],
                **spec).prune(lora_model=lora_model)
    got = export_masks(tm.visual_encoder)
    jvars = numpy_tree(jres.variables)
    if lora_model:
        want = {path[:-1]: m for path, m in flatten(jvars["masks"]).items()}
        assert set(got) == set(want) and want
        for path in want:
            np.testing.assert_array_equal(got[path], want[path])
    else:
        assert not got and "masks" not in jvars
        for path, w in flatten(jvars["params"]).items():
            if path[-1] == "kernel" and np.ndim(w) == 2:
                k = tm.visual_encoder.get_submodule(".".join(path[:-1]))
                np.testing.assert_array_equal(k.kernel.numpy() == 0, w == 0)
    full = dict(params=dict(params, visual_encoder=jvars["params"]),
                **({"masks": {"visual_encoder": jvars["masks"]}}
                   if lora_model else {}))
    image = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    want = jm.apply(full, _j(image), method=JBO.Blip2OPT.encode_image)
    np.testing.assert_allclose(tm.encode_image(_t(image)).numpy(),
                               np.asarray(want), **TOL)
