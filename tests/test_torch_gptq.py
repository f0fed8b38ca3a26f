"""GPTQ and AWQ in the port vs the JAX package on the CPU: the OBS
quantization sweep over grids (symmetric and asymmetric, 2/3/4/8 bits),
groups (per tensor, inside a block, spanning blocks, not dividing the
width), act order, joint unstructured and n:m pruning; its batched and
group forms, ``gptq_dequantize``, ``rtn_quantize`` and
``gptq_to_int4_params``; every function of ``ops/awq.py``; and the
calibration engine's GPTQ method (the three ``*_gptq_pruner`` names are
held in tests/test_torch_gptq_pruners.py).

Tolerances, and why.  On the same inputs the port's sweep gives codes,
zero points, permutations and keep masks bit for bit, and scales and
fake-quant weights within atol = rtol = 1e-5 (losses 1e-4 relative): the
port factors H with LAPACK's Cholesky through torch.linalg and inverts with
``cholesky_inverse``, the JAX package with its own blocked Cholesky and a
Neumann-doubling triangular inverse, so H⁻¹ differs in its last bits, and
so do the error-fed weights each scale is set from (measured: 2.1e-6 at
most on scales, 4.3e-6 on weights, no code moved, on every case below).
RTN and AWQ's transforms equal JAX's eager ops bit for bit.

Two things move a code by a step, and the tests that meet them state
their bounds:

  * grid ties.  The symmetric grid puts each group's most negative weight
    exactly on a rounding tie (−7.5 steps at 4 bits) wherever it is
    rounded unchanged (RTN; GPTQ at a group's first column); the last bit
    of the scale decides it (the positive extreme is clamped back to the
    same code).  A code that moves feeds its error forward along its row.
  * XLA's compiled arithmetic.  Under ``jax.jit`` (``awq_search``,
    ``awq_rtn_quantize``, the GPTQ group sweep) XLA fuses and rewrites
    float32 operations, so values differ from its own eager ops by an ulp
    (its float32 pow, which the port computes in float64 and rounds, and
    the unscale); at a tie that is a step.

Bounds: AWQ's candidate losses within 2 % (measured 0.9 %), its choice
within 2 % of JAX's best, the same α wherever JAX's best beats its second
by more; ``gptq_fn`` on symmetric grids at most 3 % of kernel entries
outside W_TOL (measured 1.46 %), masks bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_pipeline import _t
from test_torch_sparsegpt import _problem, _stats_pair
from vlm_compression_tpu.ops import awq as JA
from vlm_compression_tpu.ops import gptq as JG
from vlm_compression_tpu.ops import quant as JQ
from vlm_compression_tpu.ops import stats as JST
from vlm_compression_tpu_torch.ops import awq as TA
from vlm_compression_tpu_torch.ops import gptq as TG
from vlm_compression_tpu_torch.ops import quant as TQ
from vlm_compression_tpu_torch.ops import stats as TST

W_TOL = dict(atol=1e-5, rtol=1e-5)
LOSS_TOL = dict(atol=1e-6, rtol=1e-4)
JIT_LOSS_RTOL = 2e-2
SYM_TIE_SHARE = 0.03


def _hessian(seed, units, cols):
    w, x = _problem(seed, units, cols)
    js, ts = _stats_pair(x)
    return w, JST.finalize_hessian(js), TST.finalize_hessian(ts)


def _assert_gptq(got, want):
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.zero.numpy(), np.asarray(want.zero))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(got.keep_mask.numpy(),
                                  np.asarray(want.keep_mask))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               **W_TOL)
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               **W_TOL)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               **LOSS_TOL)
    assert got.codes.dtype == torch.uint8 and got.perm.dtype == torch.int32
    # pruned entries are exactly zero, their code the zero point
    keep = got.keep_mask.numpy()
    assert not got.weight.numpy()[~keep].any()


CASES = {
    "sym4": dict(),
    "asym4": dict(sym=False),
    "bits2": dict(bits=2),
    "bits3": dict(bits=3, sym=False),
    "bits8": dict(bits=8),
    "per_tensor": dict(groupsize=0),
    "group64": dict(groupsize=64),
    "group_spans_blocks": dict(groupsize=256),
    "act_order": dict(act_order=True),
    "act_order_asym_g64": dict(act_order=True, sym=False, groupsize=64),
    "sparse0.5": dict(sparsity=0.5),
    "sparse0.5_g64": dict(sparsity=0.5, groupsize=64),
    "2:4": dict(prune_n=2, prune_m=4),
    "sparse0.3_act_order": dict(sparsity=0.3, act_order=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_gptq_quantize_matches_jax(case):
    kw = CASES[case]
    w, jh, th = _hessian(3, 40, 256)
    want = JG.gptq_quantize(jnp.asarray(w), jh, **kw)
    got = TG.gptq_quantize(_t(w), th, **kw)
    _assert_gptq(got, want)
    ngroups = {0: 1, 64: 4, 256: 1}.get(kw.get("groupsize", 128), 2)
    assert tuple(got.scale.shape) == (40, ngroups)
    assert int(got.codes.max()) <= (1 << kw.get("bits", 4)) - 1
    if kw.get("prune_n"):
        keep = got.keep_mask.numpy().reshape(40, -1, 4).sum(-1)
        assert (keep == 2).all()
    if kw.get("sparsity"):
        assert abs(got.keep_mask.float().mean().item()
                   - (1 - kw["sparsity"])) < 0.02
    assert not got.weight.numpy()[:, 3].any()      # the dead column


@pytest.mark.parametrize("cols,groupsize,match", [
    (256, 96, "does not divide"), (192, 128, "does not divide"),
    (384, 192, "incompatible with blocksize")])
def test_gptq_group_fallbacks_warn_as_jax(cols, groupsize, match):
    """A group that does not divide the width, or neither divides nor is
    divided by the block, falls back to one grid a row, with the JAX
    package's warning."""
    w, jh, th = _hessian(4, 16, cols)
    with pytest.warns(UserWarning, match=match):
        want = JG.gptq_quantize(jnp.asarray(w), jh, groupsize=groupsize)
    with pytest.warns(UserWarning, match=match):
        got = TG.gptq_quantize(_t(w), th, groupsize=groupsize)
    _assert_gptq(got, want)
    assert got.scale.shape[1] == 1


@pytest.mark.parametrize("kw", [dict(), dict(prune_n=2, prune_m=4)],
                         ids=["sym4", "2:4"])
def test_gptq_batched_matches_jax(kw):
    ws, jhs, ths = zip(*(_hessian(5 + i, 24, 256) for i in range(3)))
    want = JG.gptq_quantize_batched(jnp.asarray(np.stack(ws)),
                                    jnp.stack(jhs), **kw)
    got = TG.gptq_quantize_batched(_t(np.stack(ws)), torch.stack(ths), **kw)
    _assert_gptq(got, want)
    one = TG.gptq_quantize(_t(ws[1]), ths[1], **kw)
    np.testing.assert_array_equal(one.codes.numpy(), got.codes[1].numpy())


def test_gptq_quantize_group_matches_jax():
    """Three equal-shape (in, units) kernels, two sharing a Hessian as
    T5's q/k/v do."""
    rng = np.random.default_rng(9)
    _, xa = _problem(10, 1, 256)
    _, xb = _problem(11, 1, 256)
    kernels = [rng.standard_normal((256, 40)).astype(np.float32)
               for _ in range(3)]
    pairs = [_stats_pair(x) for x in (xa, xa, xb)]
    want = JG.gptq_quantize_group(
        tuple(jnp.asarray(k) for k in kernels), tuple(p[0] for p in pairs),
        sparsity=0.5)
    got = TG.gptq_quantize_group([_t(k) for k in kernels],
                                 [p[1] for p in pairs], sparsity=0.5)
    for (gk, gw, gl), (wk, ww, wl) in zip(got, want):
        assert gk.shape == (256, 40) and gk.is_contiguous()
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), **W_TOL)
        np.testing.assert_allclose(float(gl), float(wl), **LOSS_TOL)


@pytest.mark.parametrize("case", ["sym4", "asym4", "act_order",
                                  "sparse0.5"])
def test_gptq_dequantize_matches_jax(case):
    """From one result's codes: the JAX function and the port's give the
    same weights, and they are the sweep's fake-quant weights."""
    w, jh, th = _hessian(6, 24, 256)
    res = JG.gptq_quantize(jnp.asarray(w), jh, **CASES[case])
    args = (res.codes, res.scale, res.zero, res.perm, res.keep_mask)
    want = np.asarray(JG.gptq_dequantize(*args))
    got = TG.gptq_dequantize(*(_t(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, np.asarray(res.weight), atol=1e-6)
    tres = TG.gptq_quantize(_t(w), th, **CASES[case])
    np.testing.assert_allclose(
        TG.gptq_dequantize(tres.codes, tres.scale, tres.zero, tres.perm,
                           tres.keep_mask).numpy(),
        tres.weight.numpy(), atol=1e-6)


@pytest.mark.parametrize("kw", [dict(), dict(bits=3, groupsize=64),
                                dict(sym=False, groupsize=0),
                                dict(groupsize=96)],
                         ids=["sym4", "bits3_g64", "asym_tensor", "g96"])
def test_rtn_quantize_equals_jax(kw):
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((20, 256))
         * rng.uniform(0.1, 3.0, 256)).astype(np.float32)
    w[2, :128] = 0.0                             # a degenerate slab
    want = np.asarray(JG.rtn_quantize(jnp.asarray(w), **kw))
    got = TG.rtn_quantize(_t(w), **kw).numpy()
    np.testing.assert_array_equal(got, want)


def test_gptq_beats_rtn_on_its_calibration_loss():
    w, _, th = _hessian(12, 32, 256)
    res = TG.gptq_quantize(_t(w), th)
    rtn = TG.rtn_quantize(_t(w))

    def obs(q):
        d = _t(w) - q
        return float(((d @ th) * d).sum())

    assert obs(res.weight) < obs(rtn)


def test_gptq_to_int4_params_matches_jax_and_serves_the_weights():
    """The symmetric 4-bit identity-order result in the int4 storage:
    JAX's bytes and scales, and dequantized it is the fake-quant weight
    bit for bit (joint pruning's zeros included)."""
    w, jh, th = _hessian(13, 24, 256)
    jres = JG.gptq_quantize(jnp.asarray(w), jh, sparsity=0.5)
    jq, js = JG.gptq_to_int4_params(jres)
    tq, ts = TG.gptq_to_int4_params(TG.GPTQResult(
        *(_t(np.asarray(a)) for a in jres)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    tres = TG.gptq_quantize(_t(w), th, sparsity=0.5)
    packed, scale = TG.gptq_to_int4_params(tres)
    np.testing.assert_array_equal(
        TQ.dequantize_weight_int4(packed, scale).numpy(),
        tres.weight.t().numpy())


@pytest.mark.parametrize("kw,match", [
    (dict(bits=8), "bits=4"), (dict(sym=False), "sym grids"),
    (dict(act_order=True), "act_order=False")])
def test_gptq_to_int4_params_refuses_other_grids(kw, match):
    w, _, th = _hessian(14, 8, 128)
    res = TG.gptq_quantize(_t(w), th, **kw)
    with pytest.raises(ValueError, match=match):
        TG.gptq_to_int4_params(res)


# ----------------------------------------------------------------- AWQ


def _awq_problem(seed, units=24, cols=256):
    """Weights and the JAX package's statistics, given to both packages."""
    w, x = _problem(seed, units, cols, dead=())
    js = _stats_pair(x)[0]
    sr, h = np.asarray(js.scaler_row), np.asarray(JST.finalize_hessian(js))
    return w, (jnp.asarray(sr), jnp.asarray(h)), (_t(sr), _t(h))


@pytest.mark.parametrize("kw", [dict(sym=False), dict(sym=False, bits=3),
                                dict(), dict(bits=3, groupsize=64),
                                dict(groupsize=0)],
                         ids=["asym4", "asym3", "sym4", "sym3_g64",
                              "sym4_per_tensor"])
def test_awq_search_matches_jax(kw):
    """Against the jitted JAX search, within the rules of the module
    docstring: every candidate's loss within 2 %, the port's choice within
    2 % of the best JAX loss, and the same α and scales (2 ulps) wherever
    JAX's best beats its second by more than that."""
    w, (jsr, jh), (tsr, th) = _awq_problem(15)
    want = JA.awq_search(jnp.asarray(w), jsr, jh, **kw)
    got = TA.awq_search(_t(w), tsr, th, **kw)
    jl, tl = np.asarray(want.losses), got.losses.numpy()
    assert tl.shape == (22,)
    # the identity is a candidate: AWQ never loses to plain RTN
    assert tl.min() <= tl[-1]
    np.testing.assert_allclose(tl, jl, rtol=JIT_LOSS_RTOL)
    assert jl[int(np.argmin(tl))] <= (1 + JIT_LOSS_RTOL) * jl.min()
    if np.sort(jl)[1] > (1 + JIT_LOSS_RTOL) * jl.min():
        assert float(got.alpha) == float(want.alpha)
        np.testing.assert_allclose(got.s.numpy(), np.asarray(want.s),
                                   rtol=3e-7, atol=0)


def test_awq_alphas_are_jax_linspace():
    np.testing.assert_array_equal(TA._alphas(21, "cpu").numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, 21)))


def test_awq_transforms_match_jax():
    """Bit for bit against the same computation in JAX's eager ops (the
    jitted ``awq_rtn_quantize`` is held by the search's rules)."""
    w, (jsr, jh), (tsr, th) = _awq_problem(16)
    s = np.asarray(JA.awq_search(jnp.asarray(w), jsr, jh).s)
    jw, jhs = JA.apply_awq(jnp.asarray(w), jh, jnp.asarray(s))
    tw, ths = TA.apply_awq(_t(w), th, _t(s))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(ths.numpy(), np.asarray(jhs))
    np.testing.assert_array_equal(
        TA.unscale_weight(tw, _t(s)).numpy(),
        np.asarray(JA.unscale_weight(jw, jnp.asarray(s))))
    for bits, group, sym in ((4, 128, True), (3, 64, False)):
        rtn = JA._rtn_grouped(jw, bits, group, sym)
        np.testing.assert_array_equal(
            TA._rtn_grouped(tw, bits, group, sym).numpy(), np.asarray(rtn))
        np.testing.assert_array_equal(
            TA.awq_rtn_quantize(_t(w), _t(s), bits, group, sym).numpy(),
            np.asarray(JA.unscale_weight(rtn, jnp.asarray(s))))


@pytest.mark.parametrize("mask", [False, True])
def test_awq_int4_matmul_matches_jax(mask):
    rng = np.random.default_rng(17)
    k, n = 256, 16
    w = rng.standard_normal((k, n)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, k).astype(np.float32)
    x = rng.standard_normal((3, k)).astype(np.float32)
    m = rng.random((k, n)) < 0.5 if mask else None
    jq, js = JQ.quantize_weight_int4(jnp.asarray(w * s[:, None]), 128)
    want = np.asarray(JA.awq_int4_matmul(
        jnp.asarray(x), jq, js, jnp.asarray(s),
        None if m is None else jnp.asarray(m)))
    got = TA.awq_int4_matmul(_t(x), _t(jq), _t(js), _t(s),
                             None if m is None else _t(m))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------- pruners


def _block_problem(seed):
    """A block's worth of linears in Flax (in, units) layout and their
    statistics in both packages: q/k/v share an input (and a Hessian), as
    T5's do; wi is another shape; one input column is dead."""
    rng = np.random.default_rng(seed)
    _, xa = _problem(seed, 1, 128)
    _, xb = _problem(seed + 1, 1, 256)
    pa, pb = _stats_pair(xa), _stats_pair(xb)
    shapes = {"q": (128, 64, pa), "k": (128, 64, pa), "v": (128, 64, pa),
              "wo": (256, 48, pb)}
    kernels = {n: rng.standard_normal(sh[:2]).astype(np.float32)
               for n, sh in shapes.items()}
    return kernels, {n: sh[2] for n, sh in shapes.items()}


@pytest.mark.parametrize("sparsity", [0.0, 0.5])
@pytest.mark.parametrize("awq", [False, True])
@pytest.mark.parametrize("sym", [True, False])
def test_gptq_fn_matches_jax(sym, awq, sparsity):
    """The calibration engine's GPTQ method (equal-shape groups, AWQ's
    search, apply, sweep and unscale) on the same kernels and statistics,
    against JAX's jitted group sweep: masks bit-equal; kernels within
    W_TOL on asymmetric grids, and on symmetric ones but for the entries
    a grid tie moved (at most SYM_TIE_SHARE of them)."""
    from vlm_compression_tpu.compression.pruners import methods as JM
    from vlm_compression_tpu_torch.compression.pruners import methods as TM

    kernels, pairs = _block_problem(18)
    kw = dict(groupsize=64, sym=sym, awq=awq)
    sp = {n: sparsity for n in kernels}
    want = JM.gptq_fn(**kw)({n: jnp.asarray(k) for n, k in kernels.items()},
                            {n: p[0] for n, p in pairs.items()}, sp)
    got = TM.gptq_fn(**kw)({n: _t(k) for n, k in kernels.items()},
                           {n: p[1] for n, p in pairs.items()}, sp)
    assert set(got.masks) == set(got.new_kernels) == set(kernels)
    for n in kernels:
        keep = got.masks[n].numpy()
        np.testing.assert_array_equal(keep, np.asarray(want.masks[n]),
                                      err_msg=n)
        assert abs(keep.mean() - (1.0 - sparsity)) < 0.02
        gk, wk = got.new_kernels[n].numpy(), np.asarray(want.new_kernels[n])
        assert got.new_kernels[n].is_contiguous()
        assert not gk[~keep].any()
        if not sym:
            np.testing.assert_allclose(gk, wk, **W_TOL, err_msg=n)
        else:
            off = ~np.isclose(gk, wk, **W_TOL)
            assert off.mean() <= SYM_TIE_SHARE, (n, off.mean())
