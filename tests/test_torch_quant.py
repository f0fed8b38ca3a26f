"""Int4 weights and the W8A8 products of the port vs the JAX package on the
CPU: quantize, unpack and dequantize; ``int4_matmul`` without a mask and
with bool and packed masks; the tree and model transforms; the dynamic and
outlier int8 × int8 products and their dispatch; SparseLinear with an int4
kernel (every mode and mask kind) and with W8A8; the bridge, the model-size
report and the bytes at rest; the tiny InstructBLIP-T5 in int4 and W8A8.

Inputs come from numpy seeds and go through both packages.  Tolerances:
int4 codes (packed bytes) and scales, unpacked values, dequantized weights,
int8 activation codes and the int32 accumulators must agree bit for bit
(the same fp32 operations in the same order); products atol = rtol = 1e-5
(fp32 sums in another order); int4 logits 1e-4, as the other model tests.

W8A8 logits of the tiny model: atol = rtol = 1e-2.  W8A8 rounds each
activation to a code at run time, and the layers between the products sum
fp32 in another order than XLA does, so an activation a few ulps from a
rounding boundary can round to the next code in one package: one step of
row scale × column scale in one term (measured: 5.2e-3 at most in the
logits with 8 outlier columns, 4.8e-7 with none, where every linear's
product on the same inputs agrees within 2.4e-7).  The codes and
accumulators themselves are held bit for bit on the same inputs above.

The W8A8 switches are module state in both packages (the JAX CLI sets
them and never resets them), so a fixture resets both packages' switches
around every test here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import numpy_tree, tiny_blip, tiny_blip_configs
from vlm_compression_tpu.compression import peft_io as JP
from vlm_compression_tpu.models import layers as JL
from vlm_compression_tpu.ops import bitmask as JB
from vlm_compression_tpu.ops import quant as JQ
from vlm_compression_tpu_torch.compression import peft_io as TP
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TBI
from vlm_compression_tpu_torch.models import layers as TL
from vlm_compression_tpu_torch.models.bridge import load_jax_variables
from vlm_compression_tpu_torch.ops import bitmask as TB
from vlm_compression_tpu_torch.ops import quant as TQ

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
W8A8_LOGIT_TOL = dict(atol=1e-2, rtol=1e-2)
MASKS = ["none", "bool", "packed128", "packed256"]


@pytest.fixture(autouse=True)
def _w8a8_switches():
    def reset():
        for q in (JQ, TQ):
            q.use_dynamic_int8(False)
            q.set_int8_outliers(0)

    reset()
    yield
    reset()


def _t(x):
    return torch.from_numpy(np.array(x))


def _mask_pair(rng, k, n, kind):
    """(JAX mask, port mask) of one kind, the same keep bits."""
    if kind == "none":
        return None, None
    m = rng.random((k, n)) < 0.5
    if kind == "bool":
        return jnp.asarray(m), _t(m)
    words = JB.pack_mask(jnp.asarray(m), int(kind[6:]))
    return words, TB.pack_mask(_t(m), int(kind[6:]))


# ---------------------------------------------------------------- int4


@pytest.mark.parametrize("k,n,group", [(128, 16, 128), (256, 24, 64),
                                       (64, 8, 32), (32, 5, 2)])
def test_int4_codes_scales_and_dequant_equal_jax(k, n, group):
    rng = np.random.default_rng(k + n + group)
    w = (rng.standard_normal((k, n))
         * rng.uniform(0.1, 3.0, (k, 1))).astype(np.float32)
    w[:group, 0] = 0.0                    # an all-zero group: scale 1e-12/7
    jq, js = JQ.quantize_weight_int4(jnp.asarray(w), group)
    tq, ts = TQ.quantize_weight_int4(_t(w), group)
    assert tq.dtype == torch.uint8 and tuple(tq.shape) == (k // 2, n)
    assert ts.dtype == torch.float32 and tuple(ts.shape) == (k // group, n)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    codes = TQ.unpack_int4(tq)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(JQ.unpack_int4(jq)))
    assert int(codes.min()) >= -7 and int(codes.max()) <= 7
    np.testing.assert_array_equal(
        TQ.dequantize_weight_int4(tq, ts).numpy(),
        np.asarray(JQ.dequantize_weight_int4(jq, js)))


def test_unpack_int4_takes_every_nibble():
    """All 256 byte values, including the code −8 the absmax grid never
    writes (GPTQ's symmetric 4-bit grid does)."""
    b = np.arange(256, dtype=np.uint8).reshape(128, 2)
    np.testing.assert_array_equal(TQ.unpack_int4(_t(b)).numpy(),
                                  np.asarray(JQ.unpack_int4(jnp.asarray(b))))


@pytest.mark.parametrize("k,group", [(100, 128), (128, 3)])
def test_int4_rejects_a_group_that_does_not_fit(k, group):
    w = torch.zeros(k, 4)
    with pytest.raises(ValueError, match="multiple of group"):
        TQ.quantize_weight_int4(w, group)
    with pytest.raises(ValueError, match="multiple of group"):
        JQ.quantize_weight_int4(jnp.zeros((k, 4)), group)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("lead", [(3,), (2, 40)])
def test_int4_matmul_matches_jax(mask, lead):
    rng = np.random.default_rng(len(lead) + len(mask))
    k, n = 256, 24
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((*lead, k)).astype(np.float32)
    jq, js = JQ.quantize_weight_int4(jnp.asarray(w), 64)
    jm, tm = _mask_pair(rng, k, n, mask)
    want = np.asarray(JQ.int4_matmul(jnp.asarray(x), jq, js, jm))
    got = TQ.int4_matmul(_t(x), _t(jq), _t(js), tm)
    assert tuple(got.shape) == want.shape == (*lead, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _tree(rng):
    return {
        "a": {"kernel": rng.standard_normal((256, 8)).astype(np.float32),
              "bias": rng.standard_normal(8).astype(np.float32)},
        "b": {"c": {"kernel": rng.standard_normal((96, 4)).astype(
            np.float32)}},               # rows not a group multiple: kept
        "d": {"kernel": rng.standard_normal((128, 128)).astype(np.float32)},
        "e": {"embedding": rng.standard_normal((128, 4)).astype(np.float32)},
    }


@pytest.mark.parametrize("min_size", [0, 4096])
def test_quantize_params_tree_int4_matches_jax(min_size):
    tree = _tree(np.random.default_rng(min_size))
    want = numpy_tree(JQ.quantize_params_tree_int4(
        jax.tree_util.tree_map(jnp.asarray, tree), 128, min_size))
    got = TQ.quantize_params_tree_int4(
        jax.tree_util.tree_map(_t, tree), 128, min_size)
    flat_w = {"/".join(str(k.key) for k in p): v for p, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {"/".join(str(k.key) for k in p): v for p, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert set(flat_g) == set(flat_w)
    assert ("a/kernel_q4" in flat_w) == (min_size == 0)
    assert "d/kernel_q4" in flat_w and "b/c/kernel" in flat_w
    for key, v in flat_w.items():
        np.testing.assert_array_equal(flat_g[key].numpy(), v, err_msg=key)


@pytest.mark.parametrize("group", [16, 32])
def test_quantize_model_int4_matches_jax_tree(group):
    """The in-place model transform gives the JAX tree transform's leaves
    (int8 kernels left alone, as JAX leaves them)."""
    _, variables, tm, _ = tiny_blip(seed=41, masks=True)
    named = dict(tm.named_modules())
    lin_names = [n for n, m in named.items()
                 if isinstance(m, TL.SparseLinear)]
    TQ.quantize_model_int8_(named[lin_names[0]])
    jparams = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    first = tuple(lin_names[0].split("."))
    sub = jparams
    for key in first[:-1]:
        sub = sub[key]
    sub[first[-1]] = JQ.quantize_params_tree(dict(sub[first[-1]]))
    want = numpy_tree(JQ.quantize_params_tree_int4(jparams, group))
    TQ.quantize_model_int4_(tm, group)
    n_q4 = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]:
        keys = [str(k.key) for k in path]
        owner = ".".join(keys[:-1])
        if keys[-1] in ("kernel", "kernel_q4", "kernel_scale") and \
                isinstance(named.get(owner), TL.SparseLinear):
            got = getattr(named[owner], keys[-1])
            assert got is not None, "/".join(keys)
            np.testing.assert_array_equal(got.detach().numpy(), leaf,
                                          err_msg="/".join(keys))
            n_q4 += keys[-1] == "kernel_q4"
    lins = [named[n] for n in lin_names]
    assert n_q4 == sum(m.kernel_q4 is not None for m in lins) > 0
    assert all((m.kernel is None) == (m.kernel_q4 is not None)
               for m in lins)
    assert named[lin_names[0]].kernel.dtype == torch.int8


# ---------------------------------------------------------------- W8A8


@pytest.mark.parametrize("m,k,n", [(1, 8, 8), (5, 30, 13), (16, 24, 8),
                                   (17, 64, 40), (40, 200, 16)])
def test_int_mm_is_the_exact_integer_product(m, k, n):
    """Padded where the card's build refuses the shape (rows to 17, widths
    to a multiple of 8), sliced back: int32 equal to the int64 product of
    the same codes."""
    rng = np.random.default_rng(m * k + n)
    a = rng.integers(-127, 128, (m, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, n)).astype(np.int8)
    got = TQ.int_mm(_t(a), _t(b))
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ b.astype(np.int64))


def _int8_problem(rng, lead, k, n):
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = (rng.standard_normal((*lead, k))
         * rng.uniform(0.1, 4.0, k)).astype(np.float32)
    q, s = JQ.quantize_weight(jnp.asarray(w))
    return x, q, s


@pytest.mark.parametrize("mask", ["none", "bool", "packed128"])
@pytest.mark.parametrize("lead", [(3,), (2, 10), (40,)])
def test_int8_matmul_dynamic_matches_jax(mask, lead):
    rng = np.random.default_rng(7 + len(lead))
    k, n = 256, 24
    x, q, s = _int8_problem(rng, lead, k, n)
    jm, tm = _mask_pair(rng, k, n, mask)
    want = np.asarray(JQ.int8_matmul_dynamic(jnp.asarray(x), q, s, jm))
    got = TQ.int8_matmul_dynamic(_t(x), _t(q), _t(s), tm)
    assert tuple(got.shape) == want.shape == (*lead, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("rows", [3, 20])
def test_int8_dynamic_codes_and_accumulators_equal_jax(rows):
    """Through the public function: against the identity codes with unit
    scales the output is codes × row scale (so the activation codes and
    scales must be equal); on integer inputs whose row maxima are 127 and
    unit scales it is the int32 accumulator itself."""
    rng = np.random.default_rng(rows)
    k, n = 64, 16
    x = (rng.standard_normal((rows, k))
         * rng.uniform(0.1, 4.0, k)).astype(np.float32)
    eye = np.eye(k, dtype=np.int8)
    ones = np.ones(k, np.float32)
    want = np.asarray(JQ.int8_matmul_dynamic(jnp.asarray(x), eye, ones))
    got = TQ.int8_matmul_dynamic(_t(x), _t(eye), _t(ones))
    np.testing.assert_array_equal(got.numpy(), want)

    xi = rng.integers(-127, 128, (rows, k)).astype(np.float32)
    xi[:, 0] = 127.0
    q = rng.integers(-127, 128, (k, n)).astype(np.int8)
    acc = xi.astype(np.int64) @ q.astype(np.int64)
    ones_n = np.ones(n, np.float32)
    want = np.asarray(JQ.int8_matmul_dynamic(jnp.asarray(xi), q, ones_n))
    got = TQ.int8_matmul_dynamic(_t(xi), _t(q), _t(ones_n))
    np.testing.assert_array_equal(want, acc.astype(np.float32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask", ["none", "bool", "packed256"])
@pytest.mark.parametrize("k_out", [0, 8, 32])
def test_int8_matmul_outlier_matches_jax(mask, k_out):
    rng = np.random.default_rng(11 + k_out)
    k, n = 256, 24
    x, q, s = _int8_problem(rng, (2, 9), k, n)
    x[..., 5] *= 40.0                      # an emergent outlier feature
    jm, tm = _mask_pair(rng, k, n, mask)
    want = np.asarray(JQ.int8_matmul_outlier(jnp.asarray(x), q, s, jm,
                                             num_outliers=k_out))
    got = TQ.int8_matmul_outlier(_t(x), _t(q), _t(s), tm,
                                 num_outliers=k_out)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_outlier_columns_break_ties_as_lax_top_k():
    """Tied column maxima (bf16 maxima tie often) go to the lower index,
    as ``lax.top_k`` orders them."""
    rng = np.random.default_rng(3)
    mag = rng.integers(0, 6, 64).astype(np.float32)   # many ties
    for k in (0, 1, 7, 20, 64):
        want = np.asarray(jax.lax.top_k(jnp.asarray(mag), k)[1])
        got = TQ.top_k_indices(_t(mag), k)
        np.testing.assert_array_equal(got.numpy(), want)


def test_select_int8_matmul_dispatch_and_restore():
    assert TQ.select_int8_matmul() is TQ.int8_matmul
    assert JQ.select_int8_matmul() is JQ.int8_matmul
    with TQ.int8_switches():
        for q in (JQ, TQ):
            q.use_dynamic_int8(True)
        assert TQ.select_int8_matmul() is TQ.int8_matmul_dynamic
        assert JQ.select_int8_matmul() is JQ.int8_matmul_dynamic
        for q in (JQ, TQ):
            q.set_int8_outliers(8)
        for q in (JQ, TQ):
            fn = q.select_int8_matmul()
            assert isinstance(fn, functools.partial)
            assert fn.func is q.int8_matmul_outlier
            assert fn.keywords == {"num_outliers": 8}
            assert q.dynamic_int8_enabled() and q.int8_outliers() == 8
    assert not TQ.dynamic_int8_enabled() and TQ.int8_outliers() == 0
    with pytest.raises(RuntimeError):
        with TQ.int8_switches():
            TQ.use_dynamic_int8(True)
            raise RuntimeError("an eval that fails")
    assert TQ.select_int8_matmul() is TQ.int8_matmul


# ---------------------------------------------- SparseLinear + bridge


def _int4_linear_variables(rng, k, n, mask, group, rank=4):
    jl = JL.SparseLinear(n, lora_rank=rank, lora_alpha=8.0)
    v = numpy_tree(jl.init(jax.random.key(0), jnp.zeros((1, k)),
                           mode="sparse_lora"))
    params = dict(v["params"])
    params["kernel"] = rng.standard_normal((k, n)).astype(np.float32)
    params["bias"] = rng.standard_normal(n).astype(np.float32)
    params = numpy_tree(JQ.quantize_params_tree_int4(
        jax.tree_util.tree_map(jnp.asarray, params), group))
    out = dict(params=params, lora={
        "lora_a": v["lora"]["lora_a"],
        "lora_b": (0.3 * rng.standard_normal((rank, n))).astype(np.float32)})
    m = rng.random((k, n)) < 0.5
    if mask == "bool":
        out["masks"] = {"mask": m}
    elif mask.startswith("packed"):
        out["masks"] = numpy_tree(JB.pack_masks_tree(
            {"mask": jnp.asarray(m)}, int(mask[6:])))
    return jl, out


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("mode", ["dense", "masked", "sparse_lora", "lora"])
def test_sparse_linear_int4_matches_jax(mask, mode):
    rng = np.random.default_rng(21)
    k, n = 256, 20
    jl, variables = _int4_linear_variables(rng, k, n, mask, 64)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    want = np.asarray(jl.apply(variables, jnp.asarray(x), mode=mode))
    tl = TL.SparseLinear(k, n, lora_rank=4, lora_alpha=8.0)
    load_jax_variables(tl, variables)
    assert tl.kernel is None and "kernel" not in tl.state_dict()
    assert tl.kernel_q4.dtype == torch.uint8
    assert not tl.kernel_q4.requires_grad
    np.testing.assert_array_equal(tl.kernel_q4.numpy(),
                                  variables["params"]["kernel_q4"])
    np.testing.assert_array_equal(tl.kernel_scale.numpy(),
                                  variables["params"]["kernel_scale"])
    got = tl(_t(x), mode=mode)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("outliers", [0, 8])
@pytest.mark.parametrize("mask", ["none", "bool", "packed128"])
@pytest.mark.parametrize("mode", ["dense", "masked"])
def test_sparse_linear_w8a8_matches_jax(outliers, mask, mode):
    rng = np.random.default_rng(23 + outliers)
    k, n = 256, 20
    jl = JL.SparseLinear(n)
    v = numpy_tree(jl.init(jax.random.key(0), jnp.zeros((1, k))))
    params = dict(v["params"], kernel=rng.standard_normal((k, n)).astype(
        np.float32), bias=rng.standard_normal(n).astype(np.float32))
    variables = dict(params=numpy_tree(JQ.quantize_params_tree(
        jax.tree_util.tree_map(jnp.asarray, params))))
    m = rng.random((k, n)) < 0.5
    if mask == "bool":
        variables["masks"] = {"mask": m}
    elif mask.startswith("packed"):
        variables["masks"] = numpy_tree(JB.pack_masks_tree(
            {"mask": jnp.asarray(m)}, int(mask[6:])))
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    tl = TL.SparseLinear(k, n)
    load_jax_variables(tl, variables)
    for q in (JQ, TQ):
        q.use_dynamic_int8(True)
        q.set_int8_outliers(outliers)
    want = np.asarray(jl.apply(variables, jnp.asarray(x), mode=mode))
    with torch.no_grad():
        got = tl(_t(x), mode=mode)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        # W8A8 differs from the weight-only product it replaces
        for q in (JQ, TQ):
            q.use_dynamic_int8(False)
        assert not np.allclose(tl(_t(x), mode=mode).numpy(), want, **TOL)


def test_set_int4_kernel_checks_shapes():
    tl = TL.SparseLinear(8, 4)
    with pytest.raises(ValueError, match="int4 kernel"):
        TL.set_int4_kernel(tl, torch.zeros(8, 4, dtype=torch.uint8),
                           torch.ones(1, 4))
    with pytest.raises(ValueError, match="int4 kernel"):
        TL.set_int4_kernel(tl, torch.zeros(4, 4, dtype=torch.int8),
                           torch.ones(1, 4))
    with pytest.raises(ValueError, match="int4 kernel"):
        TL.set_int4_kernel(tl, torch.zeros(4, 4, dtype=torch.uint8),
                           torch.ones(3, 4))
    TL.set_int4_kernel(tl, torch.zeros(4, 4, dtype=torch.uint8),
                       torch.ones(2, 4))
    TL.set_mask(tl, torch.ones(8, 4, dtype=torch.bool))
    assert tl(torch.ones(1, 8)).abs().sum() == 0


# ------------------------------------------------ model-size report


@pytest.mark.parametrize("form", ["masked", "zeroed"])
def test_model_size_accounting_int4_matches_jax(form):
    """With masks the kept entries count; without, the non-zero codes
    (rows zeroed in both packages' kernels before quantizing)."""
    _, variables, tm, _ = tiny_blip(seed=42, masks=form == "masked")
    params, masks = variables["params"], variables.get("masks", {})
    if form == "zeroed":
        params = _zero_rows(params)
        load_jax_variables(tm, dict(params=params))
    params = numpy_tree(JQ.quantize_params_tree_int4(
        jax.tree_util.tree_map(jnp.asarray, params), 16))
    TQ.quantize_model_int4_(tm, 16)
    want = JP.model_size_accounting(dict(params=params, masks=masks))
    assert TP.model_size_accounting(tm) == want
    assert want["distilled_total_size"] < want["orig_total_size"]


def _zero_rows(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _zero_rows(v)
        elif k == "kernel" and np.ndim(v) == 2:
            v = np.array(v)
            v[:8] = 0.0
            out[k] = v
        else:
            out[k] = v
    return out


def test_bytes_at_rest_int4_is_half_a_byte_a_weight():
    _, _, tm, _ = tiny_blip(seed=43, masks=True)
    lin = [m for m in tm.modules() if isinstance(m, TL.SparseLinear)]
    k_elems = sum(m.kernel.numel() for m in lin)
    TQ.quantize_model_int4_(tm, 16)
    b = TP.bytes_at_rest(tm)
    assert b["kernels"] == k_elems // 2
    assert b["scales"] == 4 * sum(m.in_features // 16 * m.features
                                  for m in lin)
    assert b["total"] == sum(t.nbytes for t in list(tm.parameters())
                             + list(tm.buffers()))


# -------------------------------------- the tiny model in int4 and W8A8


def _tiny_forward(compressed, batch, tol=LOGIT_TOL):
    jm = tiny_blip(seed=44, masks=False)[0]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jm.apply(compressed, **jb, vit_mode="masked", llm_mode="masked",
                    qformer_mode="masked")
    tm = TBI.Blip2T5Instruct(tiny_blip_configs()[1], device="cpu")
    load_jax_variables(tm, compressed)
    with torch.no_grad():
        got = tm(**{k: _t(v) for k, v in batch.items()}, vit_mode="masked",
                 llm_mode="masked", qformer_mode="masked")
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), **tol)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               **tol)


@pytest.mark.parametrize("mask", ["bool", "packed128"])
@pytest.mark.parametrize("group", [16, 32])
def test_blip2_t5_int4_logits_match_jax(mask, group):
    """The tiny fp32 InstructBLIP-T5 with random masks, quantized to int4
    in the JAX package, carried over by the bridge: the masked forward's
    logits agree within 1e-4."""
    _, variables, _, batch = tiny_blip(seed=44, masks=True)
    masks = variables["masks"]
    if mask != "bool":
        masks = numpy_tree(JB.pack_masks_tree(
            jax.tree_util.tree_map(jnp.asarray, masks), int(mask[6:])))
    _tiny_forward(dict(params=numpy_tree(JQ.quantize_params_tree_int4(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]), group)),
        masks=masks), batch)


@pytest.mark.parametrize("outliers", [0, 8])
def test_blip2_t5_w8a8_logits_match_jax(outliers):
    """Within the W8A8 tolerance of the module docstring."""
    _, variables, _, batch = tiny_blip(seed=45, masks=True)
    for q in (JQ, TQ):
        q.use_dynamic_int8(True)
        q.set_int8_outliers(outliers)
    _tiny_forward(dict(params=numpy_tree(JQ.quantize_params_tree(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))),
        masks=variables["masks"]), batch, W8A8_LOGIT_TOL)
