"""Port ops vs the JAX package on the CPU: masked matmul, attention, the
calibration-statistics fold and mask selection.

Inputs come from a numpy seed and go through both packages; the JAX side
runs as its own tests run it (CPU, fp32 at HIGHEST precision, the flash
kernel in interpret mode).  Tolerance: atol = rtol = 1e-5 per op; masks
must agree bit for bit, ties included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_compression_tpu.ops import attention as JA
from vlm_compression_tpu.ops import masked_linear as JML
from vlm_compression_tpu.ops import masks as JM
from vlm_compression_tpu.ops import stats as JS
from vlm_compression_tpu_torch.ops import attention as TA
from vlm_compression_tpu_torch.ops import masked_linear as TML
from vlm_compression_tpu_torch.ops import masks as TM
from vlm_compression_tpu_torch.ops import stats as TS

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("shape_x,k,n", [((20, 48), 48, 40),
                                          ((2, 7, 33), 33, 17),
                                          ((5, 1, 16), 16, 64)])
def test_masked_matmul_matches_jax_ref(shape_x, k, n):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape_x).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = rng.random((k, n)) < 0.5
    want = _np(JML.masked_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(mask)))
    before = TML.launches
    got = TML.masked_matmul(_t(x), _t(w), _t(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert TML.launches == before   # the CPU never launches the kernel


# ---------------------------------------------------------------- (b)


def _attn_inputs(rng, b, n, m, h, d):
    q = rng.standard_normal((b, n, h, d)).astype(np.float32)
    k = rng.standard_normal((b, m, h, d)).astype(np.float32)
    v = rng.standard_normal((b, m, h, d)).astype(np.float32)
    return q, k, v


def _bias(rng, shape):
    if shape == "pad":
        return None
    return rng.standard_normal(shape).astype(np.float32)


BIAS_CASES = [
    [],
    [(2, 3, 5, 7)],                 # full (b, h, n, m)
    [(1, 3, 5, 7)],                 # relative position (1, h, n, m)
    [(2, 1, 1, 7)],                 # padding (b, 1, 1, m)
    [(1, 1, 5, 7)],                 # additive causal (1, 1, n, m)
    [(2, 1, 5, 7)],                 # per-batch (b, 1, n, m)
    [(1, 3, 5, 7), (2, 1, 1, 7)],   # T5: position bias + padding
    [(7,)],                         # rank < 4 broadcasts from the right
]


@pytest.fixture
def jax_flash():
    JA.use_flash_attention(True)   # interpret mode off-TPU
    yield
    JA.use_flash_attention("auto")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bias_shapes", BIAS_CASES)
def test_attention_matches_jax(jax_flash, bias_shapes, causal):
    rng = np.random.default_rng(1)
    q, k, v = _attn_inputs(rng, 2, 5, 7, 3, 8)
    biases = [_bias(rng, s) for s in bias_shapes]
    jb = [jnp.asarray(x) for x in biases]
    ref = _np(JA.mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jb, scale=0.3, causal=causal))
    flash = _np(JA.attention_core(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jb, scale=0.3,
                                  causal=causal))
    got = TA.attention_core(_t(q), _t(k), _t(v), [_t(x) for x in biases],
                            scale=0.3, causal=causal).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, flash, atol=2e-5, rtol=1e-4)


def test_attention_fully_masked_row_and_causal_n_gt_m(jax_flash):
    rng = np.random.default_rng(2)
    q, k, v = _attn_inputs(rng, 1, 6, 4, 2, 8)
    bias = np.zeros((1, 1, 6, 4), np.float32)
    bias[0, 0, 1, :] = TA.NEG_INF           # a fully masked row
    for causal in (False, True):            # causal: n > m rows see no key
        want = _np(JA.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), [jnp.asarray(bias)],
                                    causal=causal))
        got = TA.attention_core(_t(q), _t(k), _t(v), [_t(bias), None],
                                causal=causal).numpy()
        np.testing.assert_allclose(got, want, **TOL)
    # the fully masked row is the uniform average of v
    np.testing.assert_allclose(got[0, 1], v[0].mean(0), **TOL)


def test_attention_vit_geometry_matches_jax_flash(jax_flash):
    """The ViT's odd geometry (n = m = 257, d = 88: ragged q and kv tiles,
    a head dim off every power of two), fp32: the JAX Pallas forward in
    interpret mode against the port's plain version, out and the per-row
    log-sum-exp the backward reads."""
    rng = np.random.default_rng(5)
    q, k, v = _attn_inputs(rng, 1, 257, 257, 3, 88)
    scale = 88 ** -0.5
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    flash = _np(JA.attention_core(jq, jk, jv, (), scale=scale))
    _, jlse = JA._flash_attention_pallas(jq, jk, jv, [], scale, False,
                                         interpret=True, return_lse=True)
    got = TA.attention_core(_t(q), _t(k), _t(v), scale=scale).numpy()
    lse = torch.logsumexp(TA._scores(_t(q), _t(k), (), scale, False), -1)
    np.testing.assert_allclose(got, flash, **TOL)
    np.testing.assert_allclose(lse.numpy(), _np(jlse), **TOL)


def test_fully_masked_row_keeps_the_reference_mean_not_the_pallas_one():
    """A known difference, kept: the JAX Pallas forward pads m to its kv
    block and masks the padded columns with NEG_INF, so a row whose real
    scores are all NEG_INF averages v over the padded length (its zero
    rows included); ``mha_reference`` and the port average over the real
    m keys.  The probe of ROADMAP.md queue 3 (b, n, m, h, d = 1, 6, 4, 2,
    8; row 1 fully masked)."""
    rng = np.random.default_rng(2)
    q, k, v = _attn_inputs(rng, 1, 6, 4, 2, 8)
    bias = np.zeros((1, 1, 6, 4), np.float32)
    bias[0, 0, 1, :] = TA.NEG_INF
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    pallas = _np(JA._flash_attention_pallas(*jargs, [jnp.asarray(bias)], 1.0,
                                            False, interpret=True))
    got = TA.attention_core(_t(q), _t(k), _t(v), [_t(bias)]).numpy()
    m_pad = int(round(float(v[0].sum(0)[0, 0] / pallas[0, 1, 0, 0])))
    assert m_pad > 4
    np.testing.assert_allclose(pallas[0, 1], v[0].sum(0) / m_pad, **TOL)
    np.testing.assert_allclose(got[0, 1], v[0].mean(0), **TOL)
    assert np.abs(pallas - got).max() == pytest.approx(1.10, abs=0.01)
    # every other row agrees
    np.testing.assert_allclose(np.delete(got, 1, axis=1),
                               np.delete(pallas, 1, axis=1), atol=2e-5,
                               rtol=1e-4)


def test_attention_decode_step_matches_jax():
    rng = np.random.default_rng(3)
    q, k, v = _attn_inputs(rng, 4, 1, 10, 2, 8)
    pos = rng.standard_normal((1, 2, 10, 10)).astype(np.float32)
    step = np.where(np.arange(10) <= 3, 0.0, -1e9).astype(np.float32)
    step = step[None, None, None, :]
    want = _np(JA.attention_core(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v),
                                 [jnp.asarray(pos[:, :, 3:4]),
                                  jnp.asarray(step)]))
    got = TA.attention_core(_t(q), _t(k), _t(v),
                            [_t(pos)[:, :, 3:4], _t(step)]).numpy()
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------- stats


@pytest.mark.parametrize("with_mask", [False, True])
def test_calib_stats_fold_matches_jax(with_mask):
    rng = np.random.default_rng(4)
    xs = [rng.standard_normal((3, 6, 12)).astype(np.float32) for _ in range(2)]
    tm = (rng.random((3, 6)) < 0.7).astype(np.int32) if with_mask else None
    js = JS.init_calib_stats(12, with_hessian=True)
    ts = TS.init_calib_stats(12, with_hessian=True)
    for x in xs:
        js = JS.update_calib_stats(js, jnp.asarray(x),
                                   None if tm is None else jnp.asarray(tm))
        ts = TS.update_calib_stats(ts, _t(x), None if tm is None else _t(tm))
    for name in ("scaler_row", "sum_metric_row", "mean", "var"):
        np.testing.assert_allclose(getattr(ts, name).numpy(),
                                   _np(getattr(js, name)), **TOL)
    assert ts.nsamples == int(js.nsamples)
    assert int(ts.ntokens) == int(js.ntokens)
    np.testing.assert_allclose(TS.finalize_hessian(ts).numpy(),
                               _np(JS.finalize_hessian(js)), **TOL)


# ---------------------------------------------------------------- (d)


def _tied_metric(rng, units, n_in, levels=5):
    """Few distinct values → many ties in every row."""
    return rng.integers(0, levels, (units, n_in)).astype(np.float32) / levels


def test_wanda_metric_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((24, 16)).astype(np.float32)
    s = rng.random(24).astype(np.float32)
    want = _np(JM.wanda_metric(jnp.asarray(w.T), jnp.asarray(s)))
    got = TM.wanda_metric(_t(w).T, _t(s)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.7, 1.0])
@pytest.mark.parametrize("tied", [False, True])
def test_unstructured_mask_bit_equal(sparsity, tied):
    rng = np.random.default_rng(6)
    met = (_tied_metric(rng, 16, 40) if tied
           else rng.random((16, 40)).astype(np.float32))
    want = _np(JM.unstructured_mask(jnp.asarray(met), sparsity))
    got = TM.unstructured_mask(_t(met), sparsity).numpy()
    np.testing.assert_array_equal(got, want)
    rnd = TM.unstructured_mask(_t(met), sparsity, rounding="round").numpy()
    np.testing.assert_array_equal(
        rnd, _np(JM.unstructured_mask(jnp.asarray(met), sparsity,
                                      rounding="round")))


@pytest.mark.parametrize("sparsity", [0.25, 0.5, 0.9])
@pytest.mark.parametrize("tied", [False, True])
def test_flat_threshold_mask_bit_equal(sparsity, tied):
    rng = np.random.default_rng(7)
    met = (_tied_metric(rng, 12, 20) if tied
           else rng.random((12, 20)).astype(np.float32))
    want = _np(JM.flat_threshold_mask(jnp.asarray(met), sparsity))
    got = TM.flat_threshold_mask(_t(met), sparsity).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,m", [(2, 4), (4, 8), (1, 4)])
@pytest.mark.parametrize("tied", [False, True])
def test_nm_mask_bit_equal(n, m, tied):
    rng = np.random.default_rng(8)
    met = (_tied_metric(rng, 10, 32, levels=3) if tied
           else rng.random((10, 32)).astype(np.float32))
    want = _np(JM.nm_structured_mask(jnp.asarray(met), n, m))
    got = TM.nm_structured_mask(_t(met), n, m).numpy()
    np.testing.assert_array_equal(got, want)


def test_unstructured_mask_infinite_metric():
    """The sort path is exact for ±inf (the JAX bisection is not)."""
    met = np.array([[np.inf, 1.0, -np.inf, 0.5, 2.0, np.inf]], np.float32)
    got = TM.unstructured_mask(_t(met), 0.5).numpy()
    np.testing.assert_array_equal(
        got, [[True, False, False, False, True, True]])


# ------------------------------------------------- masked / sparse-LoRA VJPs
# Gradients: the port's autograd Functions against jax.vjp of the JAX
# custom-VJP functions (on the CPU: the XLA reference forward and the
# hand-written backward).  fp32 on both sides; only the summation order
# differs, so 1e-5 as for the forward.


def _lora_inputs(rng, shape_x, k, n, r):
    x = rng.standard_normal(shape_x).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    mask = rng.random((k, n)) < 0.5
    a = rng.uniform(-0.5, 0.5, (k, r)).astype(np.float32)
    b = (0.3 * rng.standard_normal((r, n))).astype(np.float32)  # non-zero B
    g = rng.standard_normal(shape_x[:-1] + (n,)).astype(np.float32)
    return x, w, mask, a, b, g


def _leaf(x):
    return _t(x).requires_grad_()


@pytest.mark.parametrize("shape_x,k,n", [((20, 48), 48, 40),
                                          ((2, 7, 33), 33, 17)])
def test_masked_matmul_grads_match_jax_vjp(shape_x, k, n):
    x, w, mask, _, _, g = _lora_inputs(np.random.default_rng(10), shape_x,
                                       k, n, 2)
    want_y, vjp = __import__("jax").vjp(
        lambda x_, w_: JML.masked_matmul(x_, w_, jnp.asarray(mask)),
        jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = _leaf(x), _leaf(w)
    y = TML.masked_matmul(tx, tw, _t(mask))
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), **TOL)
    np.testing.assert_allclose(dx.numpy(), _np(jdx), **TOL)
    np.testing.assert_allclose(dw.numpy(), _np(jdw), **TOL)
    assert not dw.numpy()[~mask].any()       # dW is masked


@pytest.mark.parametrize("shape_x,k,n,r", [((20, 48), 48, 40, 4),
                                            ((2, 7, 33), 33, 17, 2),
                                            ((3, 5, 16), 16, 24, 8)])
def test_sparse_lora_matches_jax_vjp(shape_x, k, n, r):
    import jax

    x, w, mask, a, b, g = _lora_inputs(np.random.default_rng(11), shape_x,
                                       k, n, r)
    scale = 16.0 / r
    want_y, vjp = jax.vjp(
        lambda x_, w_, a_, b_: JML.sparse_lora_matmul(
            x_, w_, jnp.asarray(mask), a_, b_, scale),
        *(jnp.asarray(t) for t in (x, w, a, b)))
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(t) for t in (x, w, a, b)]
    before = TML.lora_launches
    y = TML.sparse_lora_matmul(leaves[0], leaves[1], _t(mask), leaves[2],
                               leaves[3], scale)
    got = torch.autograd.grad(y, leaves, _t(g))
    assert TML.lora_launches == before      # the CPU never launches
    np.testing.assert_allclose(y.detach().numpy(), _np(want_y), **TOL)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), _np(wt), atol=1e-4, rtol=1e-5)


def test_lora_refs_and_merge_match_jax():
    x, w, mask, a, b, _ = _lora_inputs(np.random.default_rng(12), (6, 24),
                                       24, 20, 4)
    jx = [jnp.asarray(t) for t in (x, w, mask, a, b)]
    tx = [_t(t) for t in (x, w, mask, a, b)]
    np.testing.assert_allclose(TML.lora_matmul_ref(*tx, 4.0).numpy(),
                               _np(JML.lora_matmul_ref(*jx, 4.0)), **TOL)
    np.testing.assert_allclose(TML.sparse_lora_matmul_ref(*tx, 4.0).numpy(),
                               _np(JML.sparse_lora_matmul_ref(*jx, 4.0)),
                               **TOL)
    for sparse in (True, False):
        got = TML.merge_sparse_lora(tx[1], tx[2], tx[3], tx[4], 4.0, sparse)
        want = JML.merge_sparse_lora(jx[1], jx[2], jx[3], jx[4], 4.0, sparse)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


# ------------------------------------------------------ attention backward
# The port's backward (autograd through attention_core, which runs
# flash_attention_backward_ref on the CPU) against jax.vjp of the JAX
# attention_core with the flash kernels forced on — the dq and dk/dv
# Pallas kernels in interpret mode.  fp32; the interpreter and the plain
# einsums sum in different orders: atol 2e-5, rtol 1e-4 as for the forward.

BWD_CASES = [
    # (b, n, m, h, d, bias shapes, scale, causal)
    (2, 5, 7, 3, 8, [], 0.3, False),
    (2, 6, 6, 2, 11, [(1, 2, 6, 6), "pad"], 1.0, False),   # T5 rel + pad
    (2, 4, 9, 2, 12, ["pad"], 0.25, False),                # cross, n < m
    (1, 6, 6, 2, 8, [(1, 2, 6, 6), "pad"], 1.0, True),     # decoder causal
    (2, 5, 7, 3, 8, [(2, 1, 5, 7)], 0.3, True),
]


def _bwd_inputs(rng, b, n, m, h, d, shapes):
    q, k, v = _attn_inputs(rng, b, n, m, h, d)
    biases = []
    for s in shapes:
        if s == "pad":
            keep = rng.random((b, 1, 1, m)) < 0.7
            keep[..., 0] = True
            biases.append(np.where(keep, 0.0, TA.NEG_INF).astype(np.float32))
        else:
            biases.append(rng.standard_normal(s).astype(np.float32))
    g = rng.standard_normal((b, n, h, d)).astype(np.float32)
    return q, k, v, biases, g


@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_grads_match_jax_flash_vjp(jax_flash, case):
    import jax

    b, n, m, h, d, shapes, scale, causal = case
    q, k, v, biases, g = _bwd_inputs(np.random.default_rng(13), b, n, m, h,
                                     d, shapes)
    jb = [jnp.asarray(x) for x in biases]
    _, vjp = jax.vjp(lambda q_, k_, v_: JA.attention_core(
        q_, k_, v_, jb, scale=scale, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    leaves = [_leaf(t) for t in (q, k, v)]
    out = TA.attention_core(*leaves, [_t(x) for x in biases], scale, causal)
    got = torch.autograd.grad(out, leaves, _t(g))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), _np(wt), atol=2e-5, rtol=1e-4)


# LLaMA's attention at its head dim, d = 128 (the TMA + wgmma kernels'
# DP = 128 on the card), under its one additive (b, 1, n, m) bias as the
# port's adapters and cache build it: the causal −1e9 mask + right padding
# of a training batch (n = m); a prime's cache of m slots, the query
# tokens' first (2 here, 32 in the model), then a left-padded prompt, +
# the step visibility; a decode step's pad bias + visibility up to slot
# m − 3 (n = 1).  b 2, h 2.  The forward and the VJP of q, k, v against
# the JAX flash kernels in interpret mode.  fp32; a score or gradient sums
# 128 products (or m ≤ 9 rows) in another order than the interpreter's,
# about 1e-6 at these magnitudes: atol 2e-5, rtol 1e-4 as for the other
# attention cases.
LLAMA_CASES = [("train", 9, 9, 0), ("prime", 5, 9, 2), ("decode", 1, 9, 2)]


def _llama_bias(rng, kind, b, n, m, first):
    """LLaMA's bias (b, 1, n, m); ``first``: the valid slots before a
    prompt's left pads (0: a padded prompt's first rows see no valid
    key)."""
    j = np.arange(m)
    pads = rng.integers(1, 3, size=b)
    if kind == "train":
        keep = j[None, :] < (m - pads)[:, None]
        cur = 0
    else:
        keep = (j[None, :] < first) | (j[None, :] >= first + pads[:, None])
        cur = m - 3 if kind == "decode" else 0
    pad = np.where(keep, 0.0, TA.NEG_INF)[:, None, None, :]
    vis = j[None, :] <= cur + np.arange(n)[:, None]
    return (pad + np.where(vis, 0.0, TA.NEG_INF)[None, None]).astype(
        np.float32)


def _llama_d128_case(kind, n, m, first, flash: bool):
    """(the port's out and q, k, v gradients, JAX's) at one LLaMA case;
    JAX's attention_core with its flash kernels forced on or off."""
    import jax

    rng = np.random.default_rng(21)
    q, k, v = _attn_inputs(rng, 2, n, m, 2, 128)
    bias = _llama_bias(rng, kind, 2, n, m, first)
    g = rng.standard_normal(q.shape).astype(np.float32)
    scale = 128 ** -0.5
    jb = [jnp.asarray(bias)]
    JA.use_flash_attention(flash)
    try:
        want, vjp = jax.vjp(lambda q_, k_, v_: JA.attention_core(
            q_, k_, v_, jb, scale=scale), jnp.asarray(q), jnp.asarray(k),
            jnp.asarray(v))
        want_grads = vjp(jnp.asarray(g))
    finally:
        JA.use_flash_attention("auto")
    leaves = [_leaf(t) for t in (q, k, v)]
    out = TA.attention_core(*leaves, [_t(bias)], scale)
    got_grads = torch.autograd.grad(out, leaves, _t(g))
    return ([out.detach(), *got_grads], [want, *want_grads])


@pytest.mark.parametrize("kind,n,m,first", LLAMA_CASES,
                         ids=[c[0] for c in LLAMA_CASES])
def test_llama_d128_attention_matches_jax_flash(kind, n, m, first):
    got, want = _llama_d128_case(kind, n, m, first, flash=True)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), _np(wt), atol=2e-5, rtol=1e-4)


def test_llama_d128_rows_without_a_valid_key_match_jax_reference():
    """A prime whose padded prompts start at slot 0: their first rows see
    no valid key (every score −1e9 or −2e9) and average v over the slots
    at −1e9, as the JAX package's ``mha_reference`` does (the semantics
    the kernels on the card are held to, chip_smoke's
    ``llama_rows_seeing_no_key``).  JAX's Pallas kernel masks its padded kv
    columns with −1e9 too, so there those rows also average over the
    padding: the forward is held against JAX with its flash kernels off,
    at the tolerance above.  (Their gradients are not compared: both
    packages' flash backwards recompute p from an lse that rounds to −1e9
    in fp32, so p is 1 there, not the uniform 1/count that autodiff of the
    reference differentiates; the model drops these padded rows, and a
    training batch, right-padded, has none.)"""
    got, want = _llama_d128_case("prime", 5, 9, 0, flash=False)
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_ref_matches_autograd(case):
    """The kernels' plain version (from out and lse) equals autograd
    through mha_reference, including hidden causal entries (ds = 0)."""
    b, n, m, h, d, shapes, scale, causal = case
    q, k, v, biases, g = _bwd_inputs(np.random.default_rng(14), b, n, m, h,
                                     d, shapes)
    tb = [_t(x) for x in biases]
    leaves = [_leaf(t) for t in (q, k, v)]
    want = torch.autograd.grad(TA.mha_reference(*leaves, tb, scale, causal),
                               leaves, _t(g))
    qt, kt, vt = (_t(t) for t in (q, k, v))
    s = TA._scores(qt, kt, tb, scale, causal)
    out = TA.mha_reference(qt, kt, vt, tb, scale, causal)
    got = TA.flash_attention_backward_ref(qt, kt, vt, out,
                                          torch.logsumexp(s, -1), _t(g), tb,
                                          scale, causal)
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), wt.numpy(), **TOL)


def test_attention_causal_rows_without_keys_have_zero_dq():
    """Causal with n > m: rows that see no key average v uniformly; their
    scores are hidden by a `where`, so dq is 0 there and dk gets nothing
    from them, while dv does (p = 1/m)."""
    rng = np.random.default_rng(15)
    q, k, v, _, g = _bwd_inputs(rng, 1, 6, 4, 2, 8, [])
    leaves = [_leaf(t) for t in (q, k, v)]
    dq, dk, dv = torch.autograd.grad(
        TA.attention_core(*leaves, (), 1.0, True), leaves, _t(g))
    want = torch.autograd.grad(TA.mha_reference(*leaves, (), 1.0, True),
                               leaves, _t(g))
    for gt, wt in zip((dq, dk, dv), want):
        np.testing.assert_allclose(gt.numpy(), wt.numpy(), **TOL)
    assert not dq[0, :2].any()              # rows 0, 1 see no key (m - n = -2)


def test_attention_bias_grad_on_cpu_goes_through_autograd():
    """A bias that needs a gradient takes the autograd Function on the CPU
    too (its backward runs the plain dbias, as the card runs the kernel),
    and agrees with autograd through mha_reference."""
    rng = np.random.default_rng(16)
    q, k, v, _, g = _bwd_inputs(rng, 1, 5, 5, 2, 8, [])
    bias = _leaf(rng.standard_normal((1, 2, 5, 5)).astype(np.float32))
    out = TA.attention_core(_t(q), _t(k), _t(v), [bias], 0.5)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    (db,) = torch.autograd.grad(out, (bias,), _t(g))
    bias2 = bias.detach().clone().requires_grad_()
    (want,) = torch.autograd.grad(
        TA.mha_reference(_t(q), _t(k), _t(v), [bias2], 0.5), (bias2,), _t(g))
    np.testing.assert_allclose(db.numpy(), want.numpy(), **TOL)


# dbias: autograd through the port's attention_core (the plain dbias on the
# CPU) against jax.vjp of the JAX attention_core with the flash kernels in
# interpret mode — the dbias Pallas kernel for every pattern but the key
# dim 1, which JAX serves with the reference VJP.  The patterns of JAX's
# tests/test_ops_attention.py:337-372 at small sizes, every bias with a
# gradient.  fp32: atol 2e-5, rtol 1e-4 as for dq/dk/dv (the JAX package's
# own _grad_check allows 5e-4 and 1e-3).
DBIAS_CASES = [
    # (b, n, m, h, d, bias shapes, scale, causal)
    (2, 7, 7, 2, 8, [(1, 2, 7, 7), "pad"], 1.0, False),    # T5 rel + pad
    (2, 7, 7, 2, 8, [(2, 1, 7, 7)], 8 ** -0.5, False),     # (b, 1, n, m)
    (2, 4, 9, 2, 8, ["pad"], 8 ** -0.5, False),            # cross, n != m
    (2, 6, 6, 2, 8, [(2, 2, 6, 6)], 8 ** -0.5, True),      # full, causal
    (2, 5, 7, 2, 8, [(2, 2, 5, 1)], 0.3, False),           # key dim 1
]


@pytest.mark.parametrize("case", DBIAS_CASES)
def test_attention_dbias_matches_jax_flash_vjp(jax_flash, case):
    import jax

    b, n, m, h, d, shapes, scale, causal = case
    q, k, v, biases, g = _bwd_inputs(np.random.default_rng(17), b, n, m, h,
                                     d, shapes)
    _, vjp = jax.vjp(lambda q_, k_, v_, bs: JA.attention_core(
        q_, k_, v_, list(bs), scale=scale, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        tuple(jnp.asarray(x) for x in biases))
    jq, jk, jv, jbs = vjp(jnp.asarray(g))
    leaves = [_leaf(t) for t in (q, k, v, *biases)]
    out = TA.attention_core(*leaves[:3], leaves[3:], scale, causal)
    got = torch.autograd.grad(out, leaves, _t(g))
    for gt, wt in zip(got, (jq, jk, jv, *jbs)):
        assert gt.shape == wt.shape
        np.testing.assert_allclose(gt.numpy(), _np(wt), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("case", DBIAS_CASES)
def test_flash_dbias_ref_matches_autograd(case):
    """The dbias kernel's plain version (from out and lse) equals autograd
    through mha_reference, bias by bias."""
    b, n, m, h, d, shapes, scale, causal = case
    q, k, v, biases, g = _bwd_inputs(np.random.default_rng(18), b, n, m, h,
                                     d, shapes)
    qt, kt, vt = (_t(t) for t in (q, k, v))
    tb = [_leaf(x) for x in biases]
    want = torch.autograd.grad(TA.mha_reference(qt, kt, vt, tb, scale,
                                                causal), tb, _t(g))
    tb = [x.detach() for x in tb]
    s = TA._scores(qt, kt, tb, scale, causal)
    out = TA.mha_reference(qt, kt, vt, tb, scale, causal)
    for i, w in enumerate(want):
        got = TA.flash_attention_dbias_ref(qt, kt, vt, out,
                                           torch.logsumexp(s, -1), _t(g), tb,
                                           i, scale, causal)
        np.testing.assert_allclose(got.numpy(), w.numpy(), **TOL)


@pytest.mark.parametrize("case", DBIAS_CASES)
def test_backward_ref_dbias_of_matches_dbias_ref_and_jax(jax_flash, case):
    """The whole backward's plain version with ``dbias_of`` (every bias):
    dq, dk, dv as without it, then each bias's gradient equal to
    ``flash_attention_dbias_ref``'s and, within the dbias tolerance above,
    to jax.vjp's through the JAX attention_core (flash kernels in
    interpret mode; the reference VJP for the key dim 1)."""
    import jax

    b, n, m, h, d, shapes, scale, causal = case
    q, k, v, biases, g = _bwd_inputs(np.random.default_rng(19), b, n, m, h,
                                     d, shapes)
    _, vjp = jax.vjp(lambda bs: JA.attention_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), list(bs),
        scale=scale, causal=causal), tuple(jnp.asarray(x) for x in biases))
    (jbs,) = vjp(jnp.asarray(g))
    qt, kt, vt, gt = (_t(t) for t in (q, k, v, g))
    tb = [_t(x) for x in biases]
    s = TA._scores(qt, kt, tb, scale, causal)
    out = TA.mha_reference(qt, kt, vt, tb, scale, causal)
    lse = torch.logsumexp(s, -1)
    every = tuple(range(len(tb)))
    got = TA.flash_attention_backward_ref(qt, kt, vt, out, lse, gt, tb,
                                          scale, causal, dbias_of=every)
    plain = TA.flash_attention_backward_ref(qt, kt, vt, out, lse, gt, tb,
                                            scale, causal)
    assert len(got) == 3 + len(tb) and len(plain) == 3
    for x, y in zip(got[:3], plain):
        assert torch.equal(x, y)
    for i, (db, jdb) in enumerate(zip(got[3:], jbs)):
        want = TA.flash_attention_dbias_ref(qt, kt, vt, out, lse, gt, tb, i,
                                            scale, causal)
        assert db.shape == want.shape == jdb.shape
        assert torch.equal(db, want)
        np.testing.assert_allclose(db.numpy(), _np(jdb), atol=2e-5,
                                   rtol=1e-4)
