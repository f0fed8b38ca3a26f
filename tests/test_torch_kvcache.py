"""The port's decode KV cache vs the JAX package's on the CPU
(``models/kvcache.py``): int8 codes and scales bit-equal to ``quantize_kv``'s
(round half to even, the 1e-8 floor, the ±127 clip), the dequantization
equal; per-row writes and visibility equal; int8-cache and per-row decode
logits of tiny fp32 T5 and LLaMA within atol = rtol = 1e-5 of JAX's at
every step; generate with the int8 / per-row caches equal to JAX's tokens
(greedy and beam search, whose reorder must carry the scales and a per-row
index); a full cache raises.
"""

import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import F32, numpy_tree, port_config, random_masks
from vlm_compression_tpu.models import generation as JG
from vlm_compression_tpu.models import kvcache as JKV
from vlm_compression_tpu.models import llama as JL
from vlm_compression_tpu.models import t5 as JT
from vlm_compression_tpu_torch.models import generation as TG
from vlm_compression_tpu_torch.models import kvcache as TKV
from vlm_compression_tpu_torch.models import llama as TL
from vlm_compression_tpu_torch.models import t5 as TT
from vlm_compression_tpu_torch.models.bridge import load_jax_variables

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# ------------------------------------------------------------------ codes


def _kv_values(seed, shape):
    """Normal values ×3, a zero vector (the scale's floor) and exact
    half-steps of a scale (round half to even)."""
    rng = np.random.default_rng(seed)
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, -1, -1] = (np.arange(shape[-1]) - shape[-1] // 2 + 0.5).astype(
        np.float32) * (127.0 / (shape[-1] // 2 + 0.5)) / 127.0
    return x


@pytest.mark.parametrize("shape", [(2, 7, 4, 32), (3, 1, 2, 8),
                                   (1, 5, 32, 64)])
def test_quantize_kv_is_bit_equal_to_jax(shape):
    x = _kv_values(sum(shape), shape)
    want_c, want_s = JKV.quantize_kv(_j(x))
    codes, scales = TKV.quantize_kv(_t(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    assert tuple(scales.shape) == shape[:3]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    back = TKV.dequantize_kv(codes, scales, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JKV.dequantize_kv(want_c, want_s,
                                                   jnp.float32)))
    rel = float(torch.linalg.norm(back - _t(x)) / torch.linalg.norm(_t(x)))
    assert rel < 0.006


def test_quantize_kv_of_bf16_matches_jax():
    x = _kv_values(9, (2, 3, 4, 16))
    want_c, want_s = JKV.quantize_kv(_j(x).astype(jnp.bfloat16))
    codes, scales = TKV.quantize_kv(_t(x).to(torch.bfloat16))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))


class _Cache(nn.Module):
    int8: bool
    per_row: bool

    @nn.compact
    def __call__(self, k, v):
        return JKV.cache_kv(self, k, v, int8=self.int8, per_row=self.per_row)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_cache_kv_writes_match_jax(int8, per_row):
    """Two writes (3 slots, then 1) at per-row frontiers [0, 2] or the
    shared one: the buffers, scales, returned k/v and index equal JAX's."""
    rng = np.random.default_rng(5)
    b, size, h, d = 2, 6, 2, 4
    jm = _Cache(int8, per_row)
    cache = jm.init(jax.random.key(0), jnp.zeros((b, size, h, d)),
                    jnp.zeros((b, size, h, d)))["cache"]
    start = np.array([0, 2]) if per_row else 0
    cache = dict(cache, cache_index=jnp.asarray(start, jnp.int32))
    tc = TKV.init_kv_cache(b, size, h, d, torch.float32, "cpu", int8=int8,
                           per_row=per_row)
    if per_row:
        tc["index"], tc["bound"] = _t(start).long(), 2
    for n in (3, 1):
        k = rng.standard_normal((b, n, h, d)).astype(np.float32)
        v = rng.standard_normal((b, n, h, d)).astype(np.float32)
        (jk, jv, jcur, _), cvars = jm.apply({"cache": cache}, _j(k), _j(v),
                                            mutable=["cache"])
        cache = cvars["cache"]
        tk, tv, tcur = TKV.cache_kv(tc, _t(k), _t(v))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(np.asarray(tcur), np.asarray(jcur))
        np.testing.assert_array_equal(np.asarray(tc["index"]),
                                      np.asarray(cache["cache_index"]))
    pairs = [("key", "cached_key"), ("value", "cached_value")]
    if int8:
        pairs += [("key_scale", "cached_key_scale"),
                  ("value_scale", "cached_value_scale")]
    for ours, theirs in pairs:
        np.testing.assert_array_equal(tc[ours].numpy(),
                                      np.asarray(cache[theirs]))
    full = torch.zeros((b, size, h, d))
    with pytest.raises(ValueError, match="KV cache full"):
        TKV.cache_kv(tc, full, full)


@pytest.mark.parametrize("cur,n", [([0, 3], 2), ([5, 1, 2], 1), (4, 3)])
def test_step_visibility_mask_matches_jax(cur, n):
    keep = np.ones((len(cur) if isinstance(cur, list) else 2, 7), bool)
    keep[-1, :2] = False
    prev = np.where(keep, 0.0, -1e9).astype(np.float32)[:, None, None]
    want = np.asarray(JKV.step_visibility_mask(_j(cur), n, 7, _j(prev)))
    got = TKV.step_visibility_mask(_t(cur) if isinstance(cur, list) else cur,
                                   n, 7, _t(prev))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------- decoding


def _t5_pair(seed, **cfg_kw):
    rng = np.random.default_rng(seed)
    jcfg = JT.T5Config.tiny(**F32, **cfg_kw)
    jm = JT.T5ForConditionalGeneration(jcfg)
    ids = rng.integers(2, jcfg.vocab_size, (3, 6)).astype(np.int32)
    mask = np.ones((3, 6), np.int32)
    mask[2, -2:] = 0
    variables = numpy_tree(jm.init(jax.random.key(seed), _j(ids), _j(mask),
                                   jnp.zeros((3, 3), jnp.int32),
                                   mode="dense"))
    variables["masks"] = random_masks(variables["params"], rng)
    tm = TT.T5ForConditionalGeneration(port_config(jcfg, TT.T5Config),
                                       device="cpu")
    load_jax_variables(tm, variables)
    return jm, jax.tree_util.tree_map(jnp.asarray, variables), tm, ids, mask


@pytest.mark.parametrize("int8,per_row", [(True, False), (False, True),
                                          (True, True)])
def test_t5_cached_decode_logits_match_jax(int8, per_row):
    """A one-token step, a 3-token chunk (speculative decoding's verify)
    and another step over each cache form: the logits of every call within
    1e-5 of JAX's; per-row frontiers set apart by a rollback."""
    jm, jv, tm, ids, mask = _t5_pair(3, kv_cache_int8=int8,
                                     kv_cache_per_row=per_row)
    rng = np.random.default_rng(4)
    jenc = jm.apply(jv, _j(ids), None, _j(mask), "masked",
                    method=jm.encode)
    jstep, jcache = JG.make_t5_step(jm, jv, jenc, _j(mask), "masked", 8)
    tenc = tm.encode(_t(ids), None, _t(mask), mode="masked")
    tstep, tcache = TG.make_t5_step(tm, tenc, _t(mask), "masked", 8)
    for t, n in enumerate((1, 3, 1)):
        tok = rng.integers(2, 96, (3, n)).astype(np.int32)
        want, jcache = jstep(_j(tok), jcache)
        got, tcache = tstep(_t(tok), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"call {t}")
        if t == 1 and per_row:
            idx = np.array([1, 4, 2])
            jcache = JG._rollback_cache_index(jcache, _j(idx))
            TG.rollback_cache(tcache, _t(idx), 4)


@pytest.mark.parametrize("int8", [False, True])
def test_llama_primed_int8_decode_matches_jax(int8):
    """A 6-token prime, then three steps through ``make_causal_step``,
    with and without the int8 cache: each step's logits within 1e-5 of
    JAX's."""
    from test_torch_vicuna import _llama_pair

    jm, variables, tm = _llama_pair(6)
    jm = JL.LlamaForCausalLM(dataclasses.replace(jm.cfg, kv_cache_int8=int8))
    tm.cfg = dataclasses.replace(tm.cfg, kv_cache_int8=int8)
    rng = np.random.default_rng(3)
    prime = rng.integers(1, 96, (2, 6)).astype(np.int32)
    jemb = jm.apply(variables, _j(prime), method=jm.embed_tokens)
    jstep, jcache = JL.make_causal_step(jm, variables, jemb, None,
                                        mode="masked", max_decode_len=4)
    tstep, tcache = TL.make_causal_step(tm, tm.embed_tokens(_t(prime)), None,
                                        mode="masked", max_decode_len=4)
    for t in range(3):
        tok = rng.integers(1, 96, (2, 1)).astype(np.int32)
        want, jcache = jstep(_j(tok), jcache)
        got, tcache = tstep(_t(tok), tcache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {t}")
    assert ("key_scale" in tcache["layers"][0]["self"]) == int8


@pytest.mark.parametrize("int8,per_row,beams", [
    (True, False, 1), (False, True, 1), (True, False, 3), (True, True, 3)])
def test_t5_generate_with_cache_forms_matches_jax(int8, per_row, beams):
    """Greedy and beam search: beam search reorders every per-row entry
    of the cache (int8 scales, a per-row index) as JAX's tree map does."""
    jm, jv, tm, ids, mask = _t5_pair(8, kv_cache_int8=int8,
                                     kv_cache_per_row=per_row)
    kw = dict(max_length=8, num_beams=beams, min_length=2,
              repetition_penalty=1.2, eos_token_id=1, pad_token_id=0)
    want = JG.t5_generate(jm, jv, _j(ids), _j(mask),
                          cfg=JG.GenerationConfig(**kw), mode="masked")
    got = TG.t5_generate(tm, _t(ids), _t(mask), cfg=TG.GenerationConfig(**kw),
                         mode="masked")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_beams_reorders_every_per_row_entry():
    b, k = 2, 2
    cache = {"layers": [{"self": TKV.init_kv_cache(b * k, 3, 1, 2,
                                                   torch.float32, "cpu",
                                                   int8=True, per_row=True),
                         "cross": {"key": torch.arange(4.0)}}]}
    kv = cache["layers"][0]["self"]
    for name in ("key", "value", "key_scale", "value_scale"):
        kv[name] = (torch.arange(b * k)
                    .reshape(-1, *([1] * (kv[name].dim() - 1)))
                    .expand(kv[name].shape).to(kv[name].dtype).clone())
    kv["index"] = torch.tensor([5, 6, 7, 8])
    TG._gather_beams(cache, torch.tensor([[1, 1], [0, 1]]), b, k)
    for name in ("key", "value", "key_scale", "value_scale"):
        assert kv[name].reshape(4, -1)[:, 0].tolist() == [1, 1, 2, 3]
    assert kv["index"].tolist() == [6, 6, 7, 8] and kv["bound"] == 0
    assert cache["layers"][0]["cross"]["key"].tolist() == [0, 1, 2, 3]
