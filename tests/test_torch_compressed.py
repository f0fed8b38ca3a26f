"""The compressed-serving slice of the port vs the JAX package on the CPU:
bit-packed masks, the packed masked matmul, weight-only int8, SparseLinear
with compressed leaves carried over by the weight bridge, the model-size
report, and the tiny InstructBLIP-T5 after pack + int8.

Inputs come from numpy seeds and go through both packages.  Tolerances:
packed words, int8 codes and masks must agree bit for bit; products
atol = rtol = 1e-5 against the JAX functions (the same fp32 sums); 1e-4
against the Pallas kernels run in interpret mode, which sum K in 128-row
tiles; logits 1e-4, as the other model tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_models import numpy_tree, tiny_blip, tiny_blip_configs
from vlm_compression_tpu.compression import peft_io as JP
from vlm_compression_tpu.models import layers as JL
from vlm_compression_tpu.ops import bitmask as JB
from vlm_compression_tpu.ops import masked_linear as JML
from vlm_compression_tpu.ops import quant as JQ
from vlm_compression_tpu_torch.compression import peft_io as TP
from vlm_compression_tpu_torch.models import blip2_t5_instruct as TBI
from vlm_compression_tpu_torch.models import layers as TL
from vlm_compression_tpu_torch.models.bridge import (
    export_masks,
    load_jax_variables,
    to_torch,
)
from vlm_compression_tpu_torch.ops import bitmask as TB
from vlm_compression_tpu_torch.ops import masked_linear as TML
from vlm_compression_tpu_torch.ops import quant as TQ

TOL = dict(atol=1e-5, rtol=1e-5)
PALLAS_TOL = dict(atol=1e-4, rtol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _words(t):
    """Port words (int32) as the JAX package's uint32."""
    return t.numpy().view(np.uint32)


# ------------------------------------------------------------- bitmask


@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("rows", [5, 128, 200, 256, 300, 640])
def test_pack_words_equal_jax_both_ways(group, rows):
    """Padded rows included: the words and the unpacked masks agree, and a
    mask packed by either package unpacks in the other."""
    rng = np.random.default_rng(rows + group)
    mask = rng.random((rows, 9)) < 0.5
    jw = np.asarray(JB.pack_mask(jnp.asarray(mask), group))
    tw = TB.pack_mask(_t(mask), group)
    assert tw.dtype == torch.int32
    assert tw.shape[0] == TB.packed_rows(rows, group) == jw.shape[0]
    np.testing.assert_array_equal(_words(tw), jw)
    np.testing.assert_array_equal(
        TB.unpack_mask(to_torch(jw), rows, group).numpy(), mask)
    np.testing.assert_array_equal(
        np.asarray(JB.unpack_mask(jnp.asarray(_words(tw)), rows, group)),
        mask)
    assert TB.infer_pack_group(rows, jw.shape[0]) == \
        JML.infer_pack_group(rows, jw.shape[0])


def test_pack_high_bit_words():
    """G = 256 sets bit 31: words ≥ 2³¹ travel as negative int32."""
    mask = np.zeros((256, 3), bool)
    mask[248:] = True                     # rows 248..255 → bit 31
    tw = TB.pack_mask(_t(mask), 256)
    assert (tw[:, 0] < 0).all()
    np.testing.assert_array_equal(
        _words(tw), np.asarray(JB.pack_mask(jnp.asarray(mask), 256)))
    np.testing.assert_array_equal(TB.unpack_mask(tw, 256, 256).numpy(),
                                  mask)


@pytest.mark.parametrize("group", [128, 256])
def test_masks_tree_matches_jax(group):
    rng = np.random.default_rng(group)
    tree = {"a": {"mask": rng.random((300, 8)) < 0.5},
            "b": {"c": {"mask": rng.random((64, 5)) < 0.5}}}
    jt = JB.pack_masks_tree(jax.tree_util.tree_map(jnp.asarray, tree), group)
    tt = TB.pack_masks_tree(jax.tree_util.tree_map(_t, tree), group)
    for path in (("a",), ("b", "c")):
        j, t = jt, tt
        for p in path:
            j, t = j[p], t[p]
        np.testing.assert_array_equal(_words(t["mask"]), np.asarray(j["mask"]))
        assert t["mask_rows"] == int(j["mask_rows"])
        assert t["mask_group"] == int(j["mask_group"]) == group
    back = TB.unpack_masks_tree(tt)
    np.testing.assert_array_equal(back["b"]["c"]["mask"].numpy(),
                                  tree["b"]["c"]["mask"])


# ------------------------------------------------- packed masked matmul


@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("shape_x,k,n", [((6, 300), 300, 40),
                                          ((2, 5, 256), 256, 17),
                                          ((4, 64), 64, 96)])
def test_masked_matmul_packed_matches_jax(group, shape_x, k, n):
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal(shape_x).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    p = np.asarray(JB.pack_mask(jnp.asarray(rng.random((k, n)) < 0.5),
                                group))
    want = np.asarray(JML.masked_matmul_packed(jnp.asarray(x),
                                               jnp.asarray(w),
                                               jnp.asarray(p)))
    before = TML.packed_launches
    got = TML.masked_matmul_packed(_t(x), _t(w), to_torch(p))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert TML.packed_launches == before   # the CPU never launches


@pytest.mark.parametrize("group", [128, 256])
def test_masked_matmul_packed_grads_match_jax_vjp(group):
    rng = np.random.default_rng(group + 1)
    x = rng.standard_normal((3, 7, 300)).astype(np.float32)
    w = rng.standard_normal((300, 24)).astype(np.float32)
    mask = rng.random((300, 24)) < 0.5
    p = np.asarray(JB.pack_mask(jnp.asarray(mask), group))
    g = rng.standard_normal((3, 7, 24)).astype(np.float32)
    out, vjp = jax.vjp(lambda a, b: JML.masked_matmul_packed(
        a, b, jnp.asarray(p)), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    y = TML.masked_matmul_packed(tx, tw, to_torch(p))
    dx, dw = torch.autograd.grad(y, (tx, tw), _t(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(jdw), **TOL)
    assert not dw.numpy()[~mask].any()      # pruned weights get no gradient


@pytest.mark.parametrize("group", [128, 256])
def test_masked_matmul_packed_matches_pallas_interpret(group):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    w = rng.standard_normal((512, 128)).astype(np.float32)
    p = JB.pack_mask(jnp.asarray(rng.random((512, 128)) < 0.5), group)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JML._masked_matmul_packed_pallas(
            jnp.asarray(x), jnp.asarray(w), p, group))
    got = TML.masked_matmul_packed(_t(x), _t(w), to_torch(p)).numpy()
    np.testing.assert_allclose(got, want, **PALLAS_TOL)


# ------------------------------------------------------------------ int8


def test_quantize_weight_codes_and_scales_equal():
    rng = np.random.default_rng(6)
    w = (rng.standard_normal((96, 40)) * rng.uniform(0.01, 3, 40)
         ).astype(np.float32)
    w[:, 3] = 0.0                               # an all-zero column
    w[:, 7] = rng.uniform(-100, 100, 96)        # scale 1: codes are w
    w[0, 7], w[5, 7], w[6, 7] = 127.0, 2.5, -3.5   # ties: round half even
    jq, js = JQ.quantize_weight(jnp.asarray(w))
    tq, ts = TQ.quantize_weight(_t(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        TQ.dequantize_weight(tq, ts).numpy(),
        np.asarray(JQ.dequantize_weight(jq, js)))


def _int8_case(rng, k, n, mask_kind):
    w = rng.standard_normal((k, n)).astype(np.float32)
    q, s = JQ.quantize_weight(jnp.asarray(w))
    mask = rng.random((k, n)) < 0.5
    jm = tm = None
    if mask_kind == "bool":
        jm, tm = jnp.asarray(mask), _t(mask)
    elif mask_kind.startswith("packed"):
        jm = JB.pack_mask(jnp.asarray(mask), int(mask_kind[6:]))
        tm = to_torch(jm)
    return q, s, jm, tm


@pytest.mark.parametrize("mask_kind", ["none", "bool", "packed128",
                                       "packed256"])
def test_int8_matmul_matches_jax(mask_kind):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 300)).astype(np.float32)
    q, s, jm, tm = _int8_case(rng, 300, 36, mask_kind)
    want = np.asarray(JQ.int8_matmul(jnp.asarray(x), q, s, jm))
    before = TQ.int8_launches
    got = TQ.int8_matmul(_t(x), to_torch(q), to_torch(s), tm)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert TQ.int8_launches == before


@pytest.mark.parametrize("mask_kind", ["none", "bool", "packed128",
                                       "packed256"])
def test_int8_prefill_matches_jax(mask_kind):
    """A prefill-like shape (4 requests × 72 tokens, K across two 256-row
    groups): the port's ``int8_matmul`` — the kernel's function, which the
    card runs on the Hopper loop — against the JAX package's default path,
    ``_int8_matmul_ref`` then ``(out * scale).astype(x.dtype)``, within
    1e-4 × max(1, max |ref|)."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((4, 72, 512)).astype(np.float32)
    q, s, jm, tm = _int8_case(rng, 512, 160, mask_kind)
    want = np.asarray(JQ.int8_matmul(jnp.asarray(x), q, s, jm))
    got = TQ.int8_matmul(_t(x), to_torch(q), to_torch(s), tm).numpy()
    assert got.shape == want.shape == (4, 72, 160)
    err = np.abs(got - want).max()
    assert err <= 1e-4 * max(1.0, np.abs(want).max()), err


@pytest.mark.parametrize("mask_kind", ["none", "packed128"])
def test_int8_matmul_grad_matches_jax_vjp(mask_kind):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    g = rng.standard_normal((4, 36)).astype(np.float32)
    q, s, jm, tm = _int8_case(rng, 300, 36, mask_kind)
    _, vjp = jax.vjp(lambda a: JQ.int8_matmul(a, q, s, jm), jnp.asarray(x))
    tx = _t(x).requires_grad_()
    dx, = torch.autograd.grad(TQ.int8_matmul(tx, to_torch(q), to_torch(s),
                                             tm), tx, _t(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               **TOL)


@pytest.mark.parametrize("mask_kind", ["none", "packed128", "packed256"])
def test_int8_matmul_matches_pallas_interpret(mask_kind):
    """The TPU kernel (fp32, interpret mode) takes no mask or a packed one;
    its product is scaled afterwards, as ``int8_matmul`` does."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((8, 512)).astype(np.float32)
    q, s, jm, tm = _int8_case(rng, 512, 128, mask_kind)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JQ._int8_matmul_pallas(jnp.asarray(x), q, jm) * s)
    got = TQ.int8_matmul(_t(x), to_torch(q), to_torch(s), tm).numpy()
    np.testing.assert_allclose(got, want, **PALLAS_TOL)


def test_quantize_params_tree_matches_jax():
    rng = np.random.default_rng(10)
    tree = {"l": {"kernel": rng.standard_normal((16, 8)).astype(np.float32),
                  "bias": rng.standard_normal(8).astype(np.float32)},
            "m": {"n": {"kernel": rng.standard_normal((4, 6)).astype(
                np.float32)}},
            "emb": {"embedding": rng.standard_normal((5, 3)).astype(
                np.float32)}}
    jt = JQ.quantize_params_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    tt = TQ.quantize_params_tree(jax.tree_util.tree_map(_t, tree))
    jflat = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
             jax.tree_util.tree_flatten_with_path(jt)[0]}
    tflat = {"/".join(str(k.key) for k in path): v.numpy() for path, v in
             jax.tree_util.tree_flatten_with_path(tt)[0]}
    assert set(jflat) == set(tflat)
    for key in jflat:
        np.testing.assert_array_equal(tflat[key], jflat[key], err_msg=key)
    back = TQ.dequantize_params_tree(tt)
    np.testing.assert_allclose(
        back["l"]["kernel"].numpy(),
        np.asarray(JQ.dequantize_params_tree(jt)["l"]["kernel"]), **TOL)
    assert "kernel_scale" not in back["l"]


# -------------------------------------------------- SparseLinear + bridge


def _linear_variables(rng, k, n, kernel, mask, rank=4):
    """Variables of a JAX SparseLinear (k → n, LoRA rank 4, non-zero B)
    with the given kernel ("float" / "int8") and mask ("none" / "bool" /
    "packed128" / "packed256") leaves."""
    jl = JL.SparseLinear(n, lora_rank=rank, lora_alpha=8.0)
    x = jnp.zeros((1, k), jnp.float32)
    v = numpy_tree(jl.init(jax.random.key(0), x, mode="sparse_lora"))
    params = dict(v["params"])
    params["kernel"] = rng.standard_normal((k, n)).astype(np.float32)
    params["bias"] = rng.standard_normal(n).astype(np.float32)
    if kernel == "int8":
        params = numpy_tree(JQ.quantize_params_tree(params))
    lora = {"lora_a": v["lora"]["lora_a"],
            "lora_b": (0.3 * rng.standard_normal((rank, n))).astype(
                np.float32)}
    out = dict(params=params, lora=lora)
    m = rng.random((k, n)) < 0.5
    if mask == "bool":
        out["masks"] = {"mask": m}
    elif mask.startswith("packed"):
        out["masks"] = numpy_tree(JB.pack_masks_tree(
            {"mask": jnp.asarray(m)}, int(mask[6:])))
    return jl, out


@pytest.mark.parametrize("kernel,mask", [("int8", "none"), ("int8", "bool"),
                                         ("int8", "packed128"),
                                         ("int8", "packed256"),
                                         ("float", "packed128"),
                                         ("float", "packed256")])
@pytest.mark.parametrize("mode", ["dense", "masked", "sparse_lora", "lora"])
def test_sparse_linear_compressed_leaves_match_jax(kernel, mask, mode):
    rng = np.random.default_rng(11)
    k, n = 300, 20
    jl, variables = _linear_variables(rng, k, n, kernel, mask)
    x = rng.standard_normal((2, 3, k)).astype(np.float32)
    want = np.asarray(jl.apply(variables, jnp.asarray(x), mode=mode))
    tl = TL.SparseLinear(k, n, lora_rank=4, lora_alpha=8.0)
    load_jax_variables(tl, variables)
    if kernel == "int8":
        assert tl.kernel.dtype == torch.int8 and not tl.kernel.requires_grad
        np.testing.assert_array_equal(tl.kernel.numpy(),
                                      variables["params"]["kernel"])
        np.testing.assert_array_equal(tl.kernel_scale.numpy(),
                                      variables["params"]["kernel_scale"])
    if mask.startswith("packed"):
        assert TB.infer_pack_group(k, tl.mask.shape[0]) == int(mask[6:])
        np.testing.assert_array_equal(_words(tl.mask),
                                      variables["masks"]["mask"])
    got = tl(_t(x), mode=mode)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


def test_pack_and_quantize_model_match_jax_trees():
    """The port's in-place transforms give the words and codes that the JAX
    package's tree transforms give, leaf for leaf."""
    _, variables, tm, _ = tiny_blip(seed=31, masks=True)
    TB.pack_masks_(tm, 256)
    TQ.quantize_model_int8_(tm)
    jmasks = JB.pack_masks_tree(
        jax.tree_util.tree_map(jnp.asarray, variables["masks"]), 256)
    jparams = JQ.quantize_params_tree(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    named = dict(tm.named_modules())
    n_int8 = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        keys = [str(k.key) for k in path]
        if keys[-1] in ("kernel", "kernel_scale") and \
                isinstance(named.get(".".join(keys[:-1])), TL.SparseLinear):
            got = getattr(named[".".join(keys[:-1])], keys[-1])
            np.testing.assert_array_equal(got.numpy(), np.asarray(leaf),
                                          err_msg="/".join(keys))
            n_int8 += keys[-1] == "kernel"
    assert n_int8 == sum(isinstance(m, TL.SparseLinear)
                         for m in tm.modules())
    for path, leaf in jax.tree_util.tree_flatten_with_path(jmasks)[0]:
        keys = [str(k.key) for k in path]
        if keys[-1] == "mask":
            np.testing.assert_array_equal(
                _words(named[".".join(keys[:-1])].mask), np.asarray(leaf))


# --------------------------------------------------- model-size report


@pytest.mark.parametrize("form", ["bool", "packed128", "packed256", "int8",
                                  "zeroed_int8"])
def test_model_size_accounting_matches_jax(form):
    _, variables, tm, _ = tiny_blip(seed=32, masks=True)
    params = variables["params"]
    masks = variables["masks"]
    if form.startswith("packed"):
        masks = numpy_tree(JB.pack_masks_tree(
            jax.tree_util.tree_map(jnp.asarray, masks), int(form[6:])))
        TB.pack_masks_(tm, int(form[6:]))
    if form.endswith("int8"):
        if form == "zeroed_int8":     # the serving form: zeroed, no masks
            flat_masks = {tuple(p[:-1]): m for p, m in _flat(masks).items()}
            params = _zero_off_masks(params, flat_masks)
            load_jax_variables(tm, dict(params=params))
            for m in tm.modules():
                if isinstance(m, TL.SparseLinear):
                    TL.set_mask(m, None)
            masks = {}
        params = numpy_tree(JQ.quantize_params_tree(
            jax.tree_util.tree_map(jnp.asarray, params)))
        TQ.quantize_model_int8_(tm)
    want = JP.model_size_accounting(dict(params=params, masks=masks))
    assert TP.model_size_accounting(tm) == want
    assert want["distilled_total_size"] < want["orig_total_size"]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _zero_off_masks(params, flat_masks, prefix=()):
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = _zero_off_masks(v, flat_masks, prefix + (k,))
        elif k == "kernel" and prefix in flat_masks:
            out[k] = np.where(flat_masks[prefix], v, 0).astype(v.dtype)
        else:
            out[k] = v
    return out


def test_bytes_at_rest_by_form():
    _, _, tm, _ = tiny_blip(seed=33, masks=True)
    lin = [m for m in tm.modules() if isinstance(m, TL.SparseLinear)]
    masked = [m for m in lin if m.mask is not None]
    k_elems = sum(m.kernel.numel() for m in lin)
    b = TP.bytes_at_rest(tm)
    assert b["masks"] == sum(m.kernel.numel() for m in masked)
    assert b["kernels"] == 4 * k_elems        # fp32 tiny model
    TB.pack_masks_(tm, 128)
    assert TP.bytes_at_rest(tm)["masks"] == sum(
        4 * TB.packed_rows(m.in_features) * m.features for m in masked)
    TQ.quantize_model_int8_(tm)
    b8 = TP.bytes_at_rest(tm)
    assert b8["kernels"] == k_elems
    assert b8["scales"] == 4 * sum(m.features for m in lin)
    assert b8["total"] == sum(t.nbytes for t in list(tm.parameters())
                              + list(tm.buffers()))


def test_adapter_state_round_trips_packed_masks():
    _, _, tm, _ = tiny_blip(seed=34, masks=True)
    TB.pack_masks_(tm, 256)
    want = export_masks(tm)
    state = TP.adapter_state(tm)
    _, _, fresh, _ = tiny_blip(seed=34, masks=False)
    TP.attach_adapter_state(fresh, state)
    got = export_masks(fresh)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    # the words come back as they were packed (G = 256), bit for bit
    packed = {n: m.mask for n, m in tm.named_modules()
              if isinstance(m, TL.SparseLinear) and m.mask is not None}
    fresh_masks = {n: m.mask for n, m in fresh.named_modules()
                   if isinstance(m, TL.SparseLinear) and m.mask is not None}
    assert set(fresh_masks) == set(packed)
    for n, words in packed.items():
        assert fresh_masks[n].dtype == torch.int32
        assert torch.equal(fresh_masks[n], words), n


# ------------------------------------------ tiny model after pack + int8


@pytest.mark.parametrize("group", [128, 256])
def test_blip2_t5_packed_int8_logits_match_jax(group):
    """The tiny fp32 InstructBLIP-T5 with random masks, packed at ``group``
    and quantized to int8 in the JAX package, carried over by the bridge:
    the masked forward's logits agree within 1e-4."""
    jm, variables, _, batch = tiny_blip(seed=35, masks=True)

    compressed = dict(
        params=numpy_tree(JQ.quantize_params_tree(
            jax.tree_util.tree_map(jnp.asarray, variables["params"]))),
        masks=numpy_tree(JB.pack_masks_tree(
            jax.tree_util.tree_map(jnp.asarray, variables["masks"]), group)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jm.apply(compressed, **jb, vit_mode="masked", llm_mode="masked",
                    qformer_mode="masked")
    tm = TBI.Blip2T5Instruct(tiny_blip_configs()[1], device="cpu")
    load_jax_variables(tm, compressed)
    with torch.no_grad():
        got = tm(**{k: _t(v) for k, v in batch.items()}, vit_mode="masked",
                 llm_mode="masked", qformer_mode="masked")
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               atol=1e-4, rtol=1e-4)
