"""SparseGPT in the port vs the JAX package on the CPU: the OBS solve
(unstructured and 2:4, more than one 128-column block), its batched group
form, the damped Cholesky and the inf clamp, and the ``sparsegpt`` pruners
on the tiny towers with shared parameters.

Tolerances, as the JAX package holds its own SparseGPT to the reference's
torch code (tests/test_reference_parity.py): masks bit for bit, updated
weights rtol 5e-3 / atol 5e-4 (an equivalent factorization route — a
LAPACK Cholesky and triangular solve here, the JAX package's own blocked
forms there — rounds differently); losses and importance 1e-4 relative.

The pruner tests draw every bias of the tiny towers from the seed.  At
init a LayerNorm's bias is zero, so the features a LayerNorm feeds to a
linear sum to 0 in every token and that linear's Hessian is singular.
SparseGPT's first Cholesky is undamped (the damped retry follows only a
failure), and whether a singular matrix factors is decided by its last
bits: on the tiny ViT's qkv the JAX package's factorization succeeded and
LAPACK's, through torch, failed — after which the two solve different
systems.  A trained model's LayerNorm biases are not zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (
    F32,
    numpy_tree,
    port_config,
    tiny_blip,
)
from test_torch_pipeline import SPECS, _calib_batches, _copy_spine, _t
from vlm_compression_tpu.compression import load_pruner as jax_load_pruner
from vlm_compression_tpu.compression.pruners import FlaxModel
from vlm_compression_tpu.models import eva_vit as JV
from vlm_compression_tpu.models import t5 as JT
from vlm_compression_tpu.ops import sparsegpt as JS
from vlm_compression_tpu.ops import stats as JST
from vlm_compression_tpu_torch.compression import load_pruner
from vlm_compression_tpu_torch.models import eva_vit as TV
from vlm_compression_tpu_torch.models import t5 as TT
from vlm_compression_tpu_torch.models.bridge import (
    export_masks,
    flatten,
    load_jax_variables,
)
from vlm_compression_tpu_torch.ops import sparsegpt as TS
from vlm_compression_tpu_torch.ops import stats as TST

W_TOL = dict(rtol=5e-3, atol=5e-4)
S_TOL = dict(rtol=1e-4, atol=1e-6)


def _problem(seed, units, cols, dead=(3,)):
    """Weights and a calibration Hessian with uneven column scales and
    dead (all-zero) input columns."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((units, cols)).astype(np.float32)
    x = (rng.standard_normal((4, 150, cols))
         * rng.uniform(0.2, 2.0, cols)).astype(np.float32)
    x[..., list(dead)] = 0.0
    return w, x


def _stats_pair(x):
    js = JST.init_calib_stats(x.shape[-1], with_hessian=True)
    js = JST.update_calib_stats(js, jnp.asarray(x))
    ts = TST.update_calib_stats(
        TST.init_calib_stats(x.shape[-1], with_hessian=True), _t(x))
    return js, ts


def _assert_result(got, want):
    np.testing.assert_array_equal(got.keep_mask.numpy(),
                                  np.asarray(want.keep_mask))
    np.testing.assert_allclose(got.weight.numpy(), np.asarray(want.weight),
                               **W_TOL)
    np.testing.assert_allclose(got.losses.numpy(), np.asarray(want.losses),
                               **S_TOL)
    np.testing.assert_allclose(float(got.importance),
                               float(want.importance), **S_TOL)
    # pruned entries are exactly zero
    assert not got.weight.numpy()[~got.keep_mask.numpy()].any()


@pytest.mark.parametrize("prune_n,prune_m", [(0, 0), (2, 4)])
@pytest.mark.parametrize("units,cols", [(48, 256), (40, 384), (24, 100)])
def test_sparsegpt_prune_matches_jax(prune_n, prune_m, units, cols):
    w, x = _problem(units + cols, units, cols)
    js, ts = _stats_pair(x)
    want = JS.sparsegpt_prune(jnp.asarray(w), JST.finalize_hessian(js), 0.5,
                              prune_n=prune_n, prune_m=prune_m)
    got = TS.sparsegpt_prune(_t(w), TST.finalize_hessian(ts), 0.5,
                             prune_n, prune_m)
    _assert_result(got, want)
    keep = got.keep_mask.numpy()
    if prune_n:
        assert (keep.reshape(units, -1, prune_m).sum(-1)
                == prune_m - prune_n).all()
    assert not keep[:, 3].any()     # a dead column: weight 0, pruned (tie)


@pytest.mark.parametrize("sparsity", [0.3, 0.7])
def test_sparsegpt_prune_other_sparsities_match_jax(sparsity):
    w, x = _problem(7, 32, 256)
    js, ts = _stats_pair(x)
    want = JS.sparsegpt_prune(jnp.asarray(w), JST.finalize_hessian(js),
                              sparsity)
    got = TS.sparsegpt_prune(_t(w), TST.finalize_hessian(ts), sparsity)
    _assert_result(got, want)


@pytest.mark.parametrize("prune_n,prune_m", [(0, 0), (2, 4)])
def test_sparsegpt_prune_group_matches_jax(prune_n, prune_m):
    """Three equal-shape linears (Flax (in, units) layout), two sharing
    their Hessian as T5's q/k/v do, solved as one batched group."""
    rng = np.random.default_rng(9)
    _, xa = _problem(10, 1, 256)
    _, xb = _problem(11, 1, 256)
    kernels = [rng.standard_normal((256, 40)).astype(np.float32)
               for _ in range(3)]
    pairs = [_stats_pair(x) for x in (xa, xa, xb)]
    want = JS.sparsegpt_prune_group(
        tuple(jnp.asarray(k) for k in kernels), tuple(p[0] for p in pairs),
        0.5, prune_n=prune_n, prune_m=prune_m)
    got = TS.sparsegpt_prune_group([_t(k) for k in kernels],
                                   [p[1] for p in pairs], 0.5,
                                   prune_n=prune_n, prune_m=prune_m)
    for (gk, gw, gi), (wk, ww, wi) in zip(got, want):
        assert gk.shape == (256, 40) and gk.is_contiguous()
        np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), **W_TOL)
        np.testing.assert_allclose(float(gi), float(wi), **S_TOL)


def test_damped_cholesky_retries_like_jax():
    """An indefinite matrix: both add damp·I until the factorization
    succeeds, the same number of times."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal((24, 24)).astype(np.float32)
    h = (a @ a.T - 6.0 * np.eye(24)).astype(np.float32)
    damp = np.float32(0.7)
    want = np.asarray(JS.damped_cholesky(jnp.asarray(h), jnp.asarray(damp)))
    got = TS.damped_cholesky(_t(h), torch.tensor(damp)).numpy()
    assert np.isfinite(want).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_overflowing_inverse_is_damped_not_returned():
    """H = J·L·Lᵀ·J with L = I − 2·(sub-diagonal): its Cholesky succeeds
    and the factor is finite, but the factor's inverse holds 2^(i−j) and
    overflows fp32.  The JAX package, which retries only on a NaN factor,
    returns non-finite weights; the port damps and prunes."""
    n = 160
    low = np.eye(n) - 2.0 * np.eye(n, k=-1)
    h = (low @ low.T)[::-1, ::-1].astype(np.float32)
    w = np.random.default_rng(14).standard_normal((8, n)).astype(np.float32)
    want = JS.sparsegpt_prune(jnp.asarray(w), jnp.asarray(h), 0.5)
    assert not np.isfinite(np.asarray(want.weight)).all()
    got = TS.sparsegpt_prune(_t(w), _t(h), 0.5)
    assert torch.isfinite(got.weight).all()
    assert abs(got.keep_mask.float().mean().item() - 0.5) < 0.01


@pytest.mark.parametrize("cause", ["factorization", "inverse"])
def test_damped_counts_by_cause(cause):
    """``damped`` counts each matrix once, by why its first factorization
    was not used: an indefinite H fails to factor; H = J·L·Lᵀ·J (above)
    factors, but its factor's inverse overflows."""
    if cause == "factorization":
        a = np.random.default_rng(12).standard_normal((24, 24))
        h = (a @ a.T - 6.0 * np.eye(24)).astype(np.float32)
    else:
        low = np.eye(160) - 2.0 * np.eye(160, k=-1)
        h = (low @ low.T)[::-1, ::-1].astype(np.float32)
    w = np.random.default_rng(15).standard_normal((8, h.shape[0])).astype(
        np.float32)
    before = dict(TS.damped)
    TS.sparsegpt_prune_batched(_t(np.stack([w, w])), _t(np.stack([h, h])),
                               0.5)
    got = {k: TS.damped[k] - before[k] for k in before}
    assert got == {"factorization": 2 * (cause == "factorization"),
                   "inverse": 2 * (cause == "inverse")}


def test_clamp_infs_matches_jax():
    rng = np.random.default_rng(13)
    h = rng.standard_normal((40, 40)).astype(np.float32)
    h[3, 5] = np.inf
    h[7, 1] = -np.inf
    h[9, 9] = np.inf
    want = np.asarray(JS._clamp_infs(jnp.asarray(h)))
    got = TS._clamp_infs(_t(h)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- pruners


def _assert_nm(tres, pruned, prune_n, prune_m):
    """Every mask keeps m − n of each group of m consecutive inputs."""
    masks = export_masks(tres)
    for path in pruned:
        keep = np.asarray(masks[path])
        groups = keep.reshape(keep.shape[0] // prune_m, prune_m, -1).sum(1)
        assert (groups == prune_m - prune_n).all(), "/".join(path)


def _assert_pruned_like_jax(tres, jvars, pruned, lora_model):
    """Masks bit-equal; every pruned linear's updated kernel within the
    weights' tolerance; lora_model=False keeps no mask."""
    tparams = dict(tres.named_parameters())
    params = flatten(jvars["params"])
    got_masks = export_masks(tres)
    if lora_model:
        want = {path[:-1]: np.asarray(m) for path, m in
                flatten(jvars["masks"]).items()}
        assert set(got_masks) == set(want) == set(pruned)
        for path in pruned:
            np.testing.assert_array_equal(got_masks[path], want[path],
                                          err_msg="/".join(path))
            assert abs(got_masks[path].mean() - 0.5) < 0.1
    else:
        assert got_masks == {}
    for path in pruned:
        want_k = np.asarray(params[path + ("kernel",)])
        got_k = tparams[".".join(path + ("kernel",))].detach().numpy()
        np.testing.assert_array_equal(got_k == 0, want_k == 0,
                                      err_msg="/".join(path))
        np.testing.assert_allclose(got_k, want_k, **W_TOL,
                                   err_msg="/".join(path))


def _block_linears(params, towers):
    from vlm_compression_tpu.compression.calibrate import linear_paths

    out = []
    for tower in towers:
        node = params
        for p in tower:
            node = node[p]
        for bname, bparams in node.items():
            if bname.startswith("blocks_"):
                out += [tower + (bname,) + lp for lp in linear_paths(bparams)]
    return out


def _seeded_biases(variables, tm, seed):
    """Every ``bias`` leaf drawn from the seed, in both packages."""
    rng = np.random.default_rng(seed)

    def walk(node):
        return {k: (walk(v) if isinstance(v, dict) else
                    (0.1 * rng.standard_normal(np.shape(v))).astype(v.dtype)
                    if k == "bias" else v) for k, v in node.items()}

    variables = dict(variables, params=walk(variables["params"]))
    load_jax_variables(tm, variables)
    return variables


# n:m cases calibrate on 8 batches of 8 samples: at 2 × 4 the n:m sweep
# meets near-ties whose order rounding decides, at 8 × 8 every mask is
# bit-equal to the JAX pruner's, with the seeded biases or without
NM_CASES = [(True, 0, 0), (False, 0, 0), (True, 2, 4), (True, 4, 8)]


def _nm_calibration(seed, prune_n):
    if not prune_n:
        return _calib_batches(seed), dict(SPECS)
    return (_calib_batches(seed, n=8, bs=8),
            dict(SPECS, num_samples=64, prune_n=prune_n,
                 prune_m=2 * prune_n))


@pytest.mark.parametrize("lora_model,prune_n,prune_m", NM_CASES)
def test_blipt5_sparsegpt_pruner_matches_jax(lora_model, prune_n, prune_m):
    jm, variables, tm, _ = tiny_blip(seed=41, masks=False)
    variables = _seeded_biases(variables, tm, 41)
    batches, specs = _nm_calibration(42, prune_n)
    assert specs.get("prune_m", 0) == prune_m
    jp = jax_load_pruner(
        "blipt5_sparsegpt_pruner", FlaxModel(jm, _copy_spine(variables)),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        **specs)
    jres, _ = jp.prune(lora_model=lora_model)
    tp = load_pruner("blipt5_sparsegpt_pruner", tm,
                     [{k: _t(v) for k, v in b.items()} for b in batches],
                     **specs)
    assert tp.with_hessian
    with torch.no_grad():
        tres, _ = tp.prune(lora_model=lora_model)
    assert tres is tm
    pruned = _block_linears(jres.variables["params"], (
        ("visual_encoder",), ("t5_model", "encoder"), ("t5_model", "decoder")))
    assert len(pruned) == 2 * 4 + 2 * 7 + 2 * 11
    _assert_pruned_like_jax(tres, jres.variables, pruned, lora_model)
    if prune_n:
        _assert_nm(tres, pruned, prune_n, prune_m)


def _t5_case(seed, n=2, bs=4):
    rng = np.random.default_rng(seed)
    jcfg = JT.T5Config.tiny(**F32)
    jm = JT.T5ForConditionalGeneration(jcfg)
    batches = []
    for _ in range(n):
        mask = np.ones((bs, 7), np.int32)
        mask[1, -3:] = 0
        labels = rng.integers(1, jcfg.vocab_size, (bs, 5)).astype(np.int32)
        labels[2, -2:] = -100
        batches.append(dict(
            input_ids=rng.integers(1, jcfg.vocab_size, (bs, 7)).astype(
                np.int32), attention_mask=mask, labels=labels))
    b0 = batches[0]
    variables = numpy_tree(jm.init(
        jax.random.key(seed), jnp.asarray(b0["input_ids"]),
        jnp.asarray(b0["attention_mask"]),
        JT.shift_right(jnp.asarray(np.maximum(b0["labels"], 0))),
        mode="dense"))
    tm = TT.T5ForConditionalGeneration(port_config(jcfg, TT.T5Config),
                                       device="cpu")
    return jm, variables, tm, batches, (("encoder",), ("decoder",))


def _vit_case(seed, n=2, bs=4):
    rng = np.random.default_rng(seed)
    jcfg = JV.EvaViTConfig.tiny(**F32)
    jm = JV.EvaViT(jcfg)
    batches = [dict(image=rng.standard_normal((bs, 28, 28, 3)).astype(
        np.float32)) for _ in range(n)]
    variables = numpy_tree(jm.init(jax.random.key(seed),
                                   jnp.asarray(batches[0]["image"]),
                                   mode="dense"))
    tm = TV.EvaViT(port_config(jcfg, TV.EvaViTConfig), device="cpu")
    return jm, variables, tm, batches, ((),)


@pytest.mark.parametrize("prune_n,prune_m", [(0, 0), (2, 4), (4, 8)])
@pytest.mark.parametrize("tower", ["t5", "vit"])
def test_tower_sparsegpt_pruners_match_jax(tower, prune_n, prune_m):
    jm, variables, tm, batches, towers = (_t5_case if tower == "t5"
                                          else _vit_case)(
        43, n=8 if prune_n else 2, bs=8 if prune_n else 4)
    variables = _seeded_biases(variables, tm, 43)
    spec = dict(prune_spec="2-0.5-1.0-1.0", num_samples=8)
    if prune_n:   # 8 batches of 8 samples, as the blipt5 n:m cases
        spec.update(num_samples=64, prune_n=prune_n, prune_m=prune_m)
    name = f"{tower}_sparsegpt_pruner"
    jp = jax_load_pruner(name, FlaxModel(jm, _copy_spine(variables)),
                         [{k: jnp.asarray(v) for k, v in b.items()}
                          for b in batches], **spec)
    jres, _ = jp.prune(lora_model=True)
    tp = load_pruner(name, tm, [{k: _t(v) for k, v in b.items()}
                                for b in batches], **spec)
    with torch.no_grad():
        tres, _ = tp.prune(lora_model=True)
    pruned = _block_linears(jres.variables["params"], towers)
    assert pruned
    _assert_pruned_like_jax(tres, jres.variables, pruned, True)
    if prune_n:
        _assert_nm(tres, pruned, prune_n, prune_m)
