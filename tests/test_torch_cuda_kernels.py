"""Hand-written CUDA kernels of the port vs their plain PyTorch versions.

These need the card and skip without one.  On a machine with an H100 and
no JAX, run them without the repository's JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: float32 runs both sides in exact fp32 (no TF32), so only the
summation order differs (1e-4 relative to the output's scale).  bfloat16
rounds the output (and, in attention, the probabilities before P·V) at
different points in the two versions: up to a few bf16 ulps (2e-2
relative to the output's scale).
"""

import numpy as np
import pytest
import torch

import chip_smoke as CS
from vlm_compression_tpu_torch.ops import attention as A
from vlm_compression_tpu_torch.ops import bitmask as BM
from vlm_compression_tpu_torch.ops import masked_linear as ML
from vlm_compression_tpu_torch.ops import quant as Q

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel vs plain version")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    assert err <= TOL[dtype] * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n", [
    (20, 2048, 5120),      # beam decode step, ragged M
    (515, 1408, 4224),     # ViT qkv, ragged M
    (20, 5120, 2048),      # beam decode T5 wo: split-K
    (72, 5120, 2048),      # T5 wo
    (33, 30, 13),          # nothing tiles: unvectorized loads
    (7, 1001, 77),         # unvectorized loads, split-K
])
def test_masked_matmul_matches_plain(cuda, dtype, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = torch.randn(k, n, generator=g, device=cuda).to(dtype)
    mask = torch.rand(k, n, generator=g, device=cuda) < 0.5
    before = ML.launches
    got = ML.masked_matmul(x, w, mask)
    assert ML.launches == before + 1
    _close(got, ML.masked_matmul_ref(x, w, mask), dtype)


@pytest.mark.parametrize("kind", ["masked", "sparse_lora"])
@pytest.mark.parametrize("m,k,n,loop", [
    (2056, 704, 1408, None),    # a ViT fc2 shard at calibration: Hopper
    (20, 1024, 2048, None),     # a T5 wo shard at a beam step: decode
    (4, 2560, 2048, None),      # decode, split-K
    (515, 704, 1408, ML.WMMA),  # the WMMA loop
    (20, 2560, 2048, ML.WMMA),  # the WMMA loop, split-K
])
def test_out32_is_the_bf16_outputs_sums_before_their_rounding(
        cuda, kind, m, k, n, loop):
    """A row-parallel shard's product in fp32: the kernel's own sums, so
    rounded they equal its bf16 output bit for bit, and they hold more
    than bf16 keeps; against the fp32 plain version within the bf16
    tolerance."""
    if kind == "sparse_lora" and m <= 64 and loop is None:
        loop = ML.WMMA       # sparse-LoRA has no decode route
    g = torch.Generator(device=cuda).manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    x = torch.randn(m, k, generator=g, device=cuda).to(bf16)
    w = (torch.randn(k, n, generator=g, device=cuda) * 0.05).to(bf16)
    mask = torch.rand(k, n, generator=g, device=cuda) < 0.5
    if kind == "masked":
        def call(**kw):
            return ML.masked_matmul(x, w, mask, _loop=loop, **kw)
        ref = ML.masked_matmul_ref(x, w, mask, f32)
    else:
        a = (torch.randn(k, 8, generator=g, device=cuda) * 0.05).to(bf16)
        b = (torch.randn(8, n, generator=g, device=cuda) * 0.05).to(bf16)

        def call(**kw):
            return ML.sparse_lora_matmul(x, w, mask, a, b, 2.0, _loop=loop,
                                         **kw)
        ref = ML.sparse_lora_matmul_ref(x, w, mask, a, b, 2.0, f32)
    got = call(out_dtype=f32)
    assert got.dtype == f32
    assert torch.equal(got.to(bf16), call())
    assert (got != got.to(bf16).float()).any()
    assert torch.equal(got, call(out_dtype=f32))
    _close(got, ref, bf16)


def test_masked_matmul_leading_dims_and_strided_x(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(3, 7, 96, generator=g, device=cuda)[:, :, :64]
    w = torch.randn(64, 40, generator=g, device=cuda)
    mask = torch.rand(64, 40, generator=g, device=cuda) < 0.3
    got = ML.masked_matmul(x, w, mask)
    assert got.shape == (3, 7, 40)
    _close(got, ML.masked_matmul_ref(x, w, mask), torch.float32)


def _attn_case(cuda, dtype, b, n, m, h, d, bias_shapes, seed=0):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((b, n, h, d)), device=cuda).to(dtype)
    k = torch.tensor(rng.standard_normal((b, m, h, d)), device=cuda).to(dtype)
    v = torch.tensor(rng.standard_normal((b, m, h, d)), device=cuda).to(dtype)
    biases = []
    for shape in bias_shapes:
        if shape == "pad":
            keep = rng.random((b, 1, 1, m)) < 0.8
            keep[..., 0] = True
            biases.append(torch.tensor(np.where(keep, 0.0, A.NEG_INF),
                                       dtype=torch.float32, device=cuda))
        elif shape == "relc":   # T5 decoder: position bias + causal mask
            vis = np.arange(m)[None, :] <= np.arange(n)[:, None] + (m - n)
            biases.append(torch.tensor(
                rng.standard_normal((1, h, n, m)) + np.where(vis, 0.0,
                                                             A.NEG_INF),
                dtype=torch.float32, device=cuda))
        else:
            biases.append(torch.tensor(rng.standard_normal(shape),
                                       dtype=torch.float32, device=cuda))
    return q, k, v, biases


# the route ``plan_forward`` picks (None), and each bf16 route forced with
# ``_impl``: where the route takes the case the kernel is held to the
# plain version, elsewhere ``_impl`` raises and nothing launches
@pytest.mark.parametrize("impl", [None, A.WGMMA, A.MMA])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,m,h,d,bias_shapes,scale,causal", [
    (2, 257, 257, 16, 88, [], 88 ** -0.5, False),          # EVA ViT-g self
    (2, 32, 257, 12, 64, ["pad"], 0.125, False),           # Q-Former cross
    (2, 72, 72, 32, 64, [(1, 32, 72, 72), "pad"], 1.0, False),  # T5 encoder
    (5, 1, 10, 32, 64, [(1, 32, 1, 10), (1, 1, 1, 10)], 1.0, False),  # decode
    (2, 40, 40, 4, 64, [], 0.125, True),                  # causal, n = m
    (2, 9, 5, 2, 32, [], 1.0, True),                      # causal, n > m
    (2, 9, 5, 2, 64, [], 1.0, True),                      # the same at d 64
    (1, 130, 200, 2, 100, [(1, 1, 130, 200)], 0.1, True),  # ragged tiles
    (1, 130, 200, 2, 88, [(1, 1, 130, 200)], 0.1, True),   # ragged, d 88
    (2, 80, 80, 4, 64, ["pad"], 0.125, False),    # a last kv tile of 16
    (2, 81, 81, 4, 88, [(1, 4, 81, 81)], 0.1, False),  # ... and of 17
    # LLaMA's d = 128 (DP = 128) under its one (b, 1, n, m) bias: training
    # self-attention, a VQA prime, a decode step; d 104 and 120 pad to 128
    (2, 72, 72, 32, 128, [(2, 1, 72, 72)], 128 ** -0.5, False),
    (2, 44, 55, 32, 128, [(2, 1, 44, 55)], 128 ** -0.5, False),
    (5, 1, 55, 32, 128, [(5, 1, 1, 55)], 128 ** -0.5, False),
    (2, 200, 130, 4, 128, [], 128 ** -0.5, True),   # causal, 3 kv tiles
    (2, 81, 81, 4, 104, [(1, 4, 81, 81)], 0.1, False),
    (1, 130, 200, 2, 120, [(1, 1, 130, 200)], 0.1, True),
])
def test_flash_matches_plain(cuda, impl, dtype, b, n, m, h, d, bias_shapes,
                             scale, causal):
    q, k, v, biases = _attn_case(cuda, dtype, b, n, m, h, d, bias_shapes)
    plan = A.plan_forward(n, m, d, bf16=dtype == torch.bfloat16,
                          aligned=A._tma_aligned(q, k, v))
    before = (A.launches, A.fwd_wgmma_launches)
    if impl is not None and (dtype == torch.float32 or
                             (impl == A.WGMMA and plan != A.WGMMA)):
        with pytest.raises(ValueError, match="cannot take this call"):
            A.flash_attention(q, k, v, biases, scale, causal, _impl=impl)
        assert (A.launches, A.fwd_wgmma_launches) == before
        return
    if impl is None:
        got = A.attention_core(q, k, v, biases, scale=scale, causal=causal)
    else:
        got, _ = A.flash_attention(q, k, v, biases, scale, causal,
                                   _impl=impl)
    route = impl or plan
    assert (A.launches, A.fwd_wgmma_launches) == (
        before[0] + 1, before[1] + (route == A.WGMMA))
    _close(got, A.mha_reference(q, k, v, biases, scale, causal), dtype)


def test_flash_fully_masked_row_is_uniform_average(cuda):
    q, k, v, _ = _attn_case(cuda, torch.float32, 1, 4, 6, 2, 16, [])
    bias = torch.zeros(1, 1, 4, 6, device=cuda)
    bias[0, 0, 2, :] = A.NEG_INF
    got = A.attention_core(q, k, v, [bias])
    _close(got, A.mha_reference(q, k, v, [bias]), torch.float32)
    torch.testing.assert_close(got[0, 2], v[0].mean(0), atol=1e-5, rtol=1e-5)


def test_flash_strided_views_of_fused_qkv(cuda):
    """The ViT's q, k, v as views of its fused projection run the TMA +
    wgmma forward without a copy."""
    rng = np.random.default_rng(3)
    qkv = torch.tensor(rng.standard_normal((2, 257, 3, 16, 88)),
                       device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = A.fwd_wgmma_launches
    got = A.attention_core(q, k, v, scale=88 ** -0.5)
    assert A.fwd_wgmma_launches == before + 1
    _close(got, A.mha_reference(q, k, v, (), 88 ** -0.5), torch.bfloat16)


@pytest.mark.parametrize("dtype,impl", [(torch.float32, None),
                                        (torch.bfloat16, A.WGMMA),
                                        (torch.bfloat16, A.MMA)])
def test_flash_lse(cuda, dtype, impl):
    """The log-sum-exp the backward reads, against the plain one of the
    same (bf16-rounded) inputs: both sum exact products in fp32."""
    q, k, v, biases = _attn_case(cuda, dtype, 2, 20, 30, 3, 64,
                                 [(2, 1, 1, 30)])
    _, lse = A.flash_attention(q, k, v, biases, scale=0.2, _impl=impl)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * 0.2 \
        + biases[0]
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("impl", [A.WGMMA, A.MMA])
@pytest.mark.parametrize("d_causal,d_masked", [(64, 88), (128, 128)])
def test_flash_rows_without_keys_are_uniform_averages_in_bf16(
        cuda, impl, d_causal, d_masked):
    """bf16 rows that see no key — causal with n > m, and a row whose every
    bias entry is NEG_INF — take the uniform average over the real m keys
    on both routes (the TMA + wgmma kernel's padded kv columns are −inf,
    never NEG_INF), at the towers' head dims and LLaMA's."""
    q, k, v, _ = _attn_case(cuda, torch.bfloat16, 2, 9, 5, 2, d_causal, [])
    got, _ = A.flash_attention(q, k, v, (), 1.0, True, _impl=impl)
    _close(got, A.mha_reference(q, k, v, (), 1.0, True), torch.bfloat16)
    # rows 0-3 see no key: the mean of v over the 5 keys
    want = v.float().mean(1, keepdim=True).expand(2, 4, 2, d_causal)
    torch.testing.assert_close(got[:, :4].float(), want, atol=2e-2,
                               rtol=2e-2)
    q, k, v, _ = _attn_case(cuda, torch.bfloat16, 1, 70, 70, 2, d_masked,
                            [])
    bias = torch.zeros(1, 1, 70, 70, device=cuda)
    bias[0, 0, 5, :] = A.NEG_INF
    got, _ = A.flash_attention(q, k, v, [bias], 0.125, _impl=impl)
    _close(got, A.mha_reference(q, k, v, [bias], 0.125), torch.bfloat16)
    torch.testing.assert_close(got[0, 5].float(), v[0].float().mean(0),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,n,m,h,d,bias_shapes", [
    (2, 72, 72, 8, 64, [(1, 8, 72, 72), "pad"]),    # T5 encoder
    (2, 72, 72, 8, 128, [(2, 1, 72, 72)]),          # LLaMA's d = 128
    (8, 1, 55, 8, 128, [(8, 1, 1, 55)]),            # ... a decode step
])
def test_flash_wgmma_two_calls_are_bit_equal(cuda, b, n, m, h, d,
                                             bias_shapes):
    """The TMA + wgmma forward sums in a fixed order (no atomics)."""
    q, k, v, biases = _attn_case(cuda, torch.bfloat16, b, n, m, h, d,
                                 bias_shapes)
    out1, lse1 = A.flash_attention(q, k, v, biases, 1.0, _impl=A.WGMMA)
    out2, lse2 = A.flash_attention(q, k, v, biases, 1.0, _impl=A.WGMMA)
    assert torch.equal(out1, out2) and torch.equal(lse1, lse2)


@pytest.mark.parametrize("b,n,m,h,d,bias_shapes,scale", [
    (2, 257, 257, 16, 88, [], 88 ** -0.5),                  # EVA ViT-g self
    (2, 72, 72, 8, 64, [(1, 8, 72, 72), "pad"], 1.0),       # T5 encoder
])
def test_bf16_autograd_forward_runs_the_wgmma_routes(cuda, b, n, m, h, d,
                                                     bias_shapes, scale):
    """Under autograd the ViT's and T5's bf16 attention runs the TMA +
    wgmma forward, and its out and lse feed the TMA + wgmma backward to the
    plain backward's tolerance (the plain backward fed the plain
    forward's out and lse)."""
    q, k, v, biases = _attn_case(cuda, torch.bfloat16, b, n, m, h, d,
                                 bias_shapes)
    g = torch.tensor(np.random.default_rng(9).standard_normal((b, n, h, d)),
                     device=cuda).to(torch.bfloat16)
    leaves = [t.requires_grad_() for t in (q, k, v)]
    before = (A.fwd_wgmma_launches, A.bwd_wgmma_launches)
    out = A.attention_core(q, k, v, biases, scale)
    got = torch.autograd.grad(out, leaves, g)
    assert (A.fwd_wgmma_launches, A.bwd_wgmma_launches) == (
        before[0] + 1, before[1] + 1)
    qd, kd, vd = (t.detach() for t in leaves)
    ref_out = A.mha_reference(qd, kd, vd, biases, scale)
    ref_lse = torch.logsumexp(A._scores(qd, kd, biases, scale, False), -1)
    _close(out, ref_out, torch.bfloat16)
    want = A.flash_attention_backward_ref(qd, kd, vd, ref_out, ref_lse, g,
                                          biases, scale)
    for gg, ww in zip(got, want):
        _close(gg, ww, torch.bfloat16)


# ------------------------------------------------------- sparse-LoRA kernel
# Tolerance as the masked matmul's: the kernel sums Σ_r A·B in another
# order than the plain version's matmul, which now and then flips one bf16
# ulp of the merged weight E before the product.


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,r", [
    (514, 1408, 4224, 4),     # ViT qkv (b = 2), ragged M
    (144, 2048, 5120, 8),     # T5 wi, split-K
    (24, 5120, 2048, 8),      # T5 decoder wo, split-K
    (64, 768, 768, 2),        # Q-Former
    (33, 30, 13, 3),          # nothing tiles: unvectorized loads
    (300, 256, 136, 128),     # the largest rank
])
def test_sparse_lora_matches_plain(cuda, dtype, m, k, n, r):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(k, n, generator=g, device=cuda) * k ** -0.5).to(dtype)
    mask = torch.rand(k, n, generator=g, device=cuda) < 0.5
    a = (torch.rand(k, r, generator=g, device=cuda) - 0.5).to(dtype)
    b = (torch.randn(r, n, generator=g, device=cuda) * 0.05).to(dtype)
    before = ML.lora_launches
    got = ML.sparse_lora_matmul(x, w, mask, a, b, 16.0 / r)
    assert ML.lora_launches == before + 1
    _close(got, ML.sparse_lora_matmul_ref(x, w, mask, a, b, 16.0 / r), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sparse_lora_grads_match_plain(cuda, dtype):
    """The Function's backward (the JAX VJP; on the card Gm from a bf16
    product with fp32 output) against autograd through the plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(3, 50, 96, generator=g, device=cuda).to(dtype)
    w = (torch.randn(96, 72, generator=g, device=cuda) * 0.1).to(dtype)
    mask = torch.rand(96, 72, generator=g, device=cuda) < 0.5
    a = torch.randn(96, 4, generator=g, device=cuda).to(dtype)
    b = (torch.randn(4, 72, generator=g, device=cuda) * 0.1).to(dtype)
    gy = torch.randn(3, 50, 72, generator=g, device=cuda).to(dtype)
    leaves = [t.requires_grad_() for t in (x, a, b)]
    got = torch.autograd.grad(ML.sparse_lora_matmul(x, w, mask, a, b, 4.0),
                              leaves, gy)
    want = torch.autograd.grad(ML.sparse_lora_matmul_ref(x, w, mask, a, b,
                                                         4.0), leaves, gy)
    for gg, ww in zip(got, want):
        _close(gg, ww, dtype)


# ---------------------------------------------- flash backward (dq, dk/dv)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,m,h,d,bias_shapes,scale,causal", [
    (2, 257, 257, 16, 88, [], 88 ** -0.5, False),          # EVA ViT-g self
    (2, 32, 257, 12, 64, ["pad"], 0.125, False),           # Q-Former cross
    (2, 72, 72, 12, 64, ["pad"], 0.125, False),            # Q-Former self
    (2, 72, 72, 32, 64, [(1, 32, 72, 72), "pad"], 1.0, False),  # T5 encoder
    (2, 12, 12, 32, 64, [(1, 32, 12, 12), "pad"], 1.0, False),  # T5 decoder
    (2, 12, 72, 32, 64, ["pad"], 1.0, False),              # T5 cross
    (2, 40, 40, 4, 64, [], 0.125, True),                  # causal, n = m
    (2, 9, 5, 2, 32, [], 1.0, True),                      # causal, n > m
    (1, 130, 200, 2, 100, [(1, 1, 130, 200)], 0.1, True),  # ragged tiles
])
def test_flash_backward_matches_plain(cuda, dtype, b, n, m, h, d,
                                      bias_shapes, scale, causal):
    q, k, v, biases = _attn_case(cuda, dtype, b, n, m, h, d, bias_shapes)
    g = torch.tensor(np.random.default_rng(9).standard_normal((b, n, h, d)),
                     device=cuda).to(dtype)
    out, lse = A.flash_attention(q, k, v, biases, scale, causal)
    before = (A.dq_launches, A.dkv_launches, A.bwd_wgmma_launches)
    got = A.flash_attention_backward(q, k, v, out, lse, g, biases, scale,
                                     causal)
    # the route ``plan`` picks: one TMA + wgmma launch, or dq and dk/dv
    wg = A.plan(n, m, d, bf16=dtype == torch.bfloat16) == A.WGMMA
    assert (A.dq_launches, A.dkv_launches, A.bwd_wgmma_launches) == (
        before[0] + (not wg), before[1] + (not wg), before[2] + wg)
    want = A.flash_attention_backward_ref(q, k, v, out, lse, g, biases,
                                          scale, causal)
    for gg, ww in zip(got, want):
        _close(gg, ww, dtype)


# the bf16 TMA + wgmma route (forced where ``plan`` would pick it anyway)
# and the mma.sync route, each against the plain version, with dq alone
# and dk/dv alone; the dq slabs' sum runs in another order than the plain
# version, as the mma.sync kernels' registers do: the bf16 tolerance holds
BWD_CASES = [
    (2, 257, 257, 16, 88, [], 88 ** -0.5, False),          # EVA ViT-g self
    (2, 32, 257, 12, 64, ["pad"], 0.125, False),           # Q-Former cross
    (2, 72, 72, 12, 64, ["pad"], 0.125, False),            # Q-Former self
    (2, 72, 72, 32, 64, [(1, 32, 72, 72), "pad"], 1.0, False),  # T5 encoder
    (2, 12, 12, 32, 64, ["relc", "pad"], 1.0, False),     # T5 decoder self
    (2, 12, 72, 32, 64, ["pad"], 1.0, False),              # T5 cross
    (2, 40, 40, 4, 64, [], 0.125, True),                  # causal, n = m
    (2, 9, 5, 2, 64, [], 1.0, True),                      # causal, n > m
    (2, 200, 200, 4, 88, [(1, 4, 200, 200)], 0.125, False),   # ragged
    (1, 130, 200, 2, 40, [(1, 1, 130, 200)], 0.1, True),  # ragged, causal
    (2, 200, 130, 4, 64, [], 0.125, True),    # causal, n > m, 3 kv tiles
    # LLaMA's d = 128 (the dQ product on a warpgroup of its own): the
    # retrain's self-attention, four q and kv tiles (dSᵀ buffers reused),
    # causal n > m; d 104 pads to 128
    (2, 72, 72, 32, 128, [(2, 1, 72, 72)], 128 ** -0.5, False),
    (2, 200, 200, 4, 128, [(2, 1, 200, 200)], 128 ** -0.5, False),
    (2, 200, 130, 4, 128, [], 128 ** -0.5, True),
    (1, 130, 130, 2, 104, [(1, 2, 130, 130)], 0.1, False),
]


@pytest.mark.parametrize("impl", [A.WGMMA, A.MMA])
@pytest.mark.parametrize("need", [(True, True), (True, False),
                                  (False, True)])
@pytest.mark.parametrize("b,n,m,h,d,bias_shapes,scale,causal", BWD_CASES)
def test_flash_backward_routes_match_plain(cuda, impl, need, b, n, m, h, d,
                                           bias_shapes, scale, causal):
    q, k, v, biases = _attn_case(cuda, torch.bfloat16, b, n, m, h, d,
                                 bias_shapes)
    g = torch.tensor(np.random.default_rng(9).standard_normal((b, n, h, d)),
                     device=cuda).to(torch.bfloat16)
    out, lse = A.flash_attention(q, k, v, biases, scale, causal)
    before = A.bwd_wgmma_launches
    got = A.flash_attention_backward(q, k, v, out, lse, g, biases, scale,
                                     causal, *need, _impl=impl)
    assert A.bwd_wgmma_launches == before + (impl == A.WGMMA)
    want = A.flash_attention_backward_ref(q, k, v, out, lse, g, biases,
                                          scale, causal)
    for gg, ww, asked in zip(got, want, (need[0], need[1], need[1])):
        assert (gg is None) == (not asked)
        if asked:
            _close(gg, ww, torch.bfloat16)


def test_flash_backward_wgmma_on_views_of_fused_qkv(cuda):
    rng = np.random.default_rng(3)
    qkv = torch.tensor(rng.standard_normal((2, 257, 3, 16, 88)),
                       device=cuda).to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    g = torch.tensor(rng.standard_normal((2, 257, 16, 88)),
                     device=cuda).to(torch.bfloat16)
    out, lse = A.flash_attention(q, k, v, (), 88 ** -0.5)
    assert A._tma_aligned(q, k, v, g, out)
    before = A.bwd_wgmma_launches
    got = A.flash_attention_backward(q, k, v, out, lse, g, (), 88 ** -0.5)
    assert A.bwd_wgmma_launches == before + 1
    want = A.flash_attention_backward_ref(q, k, v, out, lse, g, (),
                                          88 ** -0.5)
    for gg, ww in zip(got, want):
        _close(gg, ww, torch.bfloat16)


def test_bf16_attention_autograd_runs_the_wgmma_backward(cuda):
    q, k, v, biases = _attn_case(cuda, torch.bfloat16, 2, 72, 72, 8, 64,
                                 [(1, 8, 72, 72), "pad"])
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    g = torch.randn(2, 72, 8, 64, device=cuda).to(torch.bfloat16)
    before = (A.bwd_wgmma_launches, A.dq_launches, A.dkv_launches)
    got = torch.autograd.grad(A.attention_core(q, k, v, biases, 1.0),
                              (q, k, v), g)
    assert (A.bwd_wgmma_launches, A.dq_launches, A.dkv_launches) == (
        before[0] + 1, before[1], before[2])
    out, lse = A.flash_attention(q.detach(), k.detach(), v.detach(), biases,
                                 1.0)
    want = A.flash_attention_backward_ref(q.detach(), k.detach(), v.detach(),
                                          out, lse, g, biases, 1.0)
    for gg, ww in zip(got, want):
        _close(gg, ww, torch.bfloat16)


def test_the_pre_pass_delta_matches_plain(cuda):
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v, _ = _attn_case(cuda, dtype, 2, 72, 72, 4, 88, [])
        g = torch.randn(2, 72, 4, 88, device=cuda).to(dtype)
        out, _ = A.flash_attention(q, k, v)
        want = torch.einsum("bnhd,bnhd->bhn", g.float(), out.float())
        torch.testing.assert_close(A._delta(g, out), want, rtol=1e-5,
                                   atol=1e-5)
        # scalar loads: a head dim off 8
        g2, o2 = g[..., :84].contiguous(), out[..., :84].contiguous()
        torch.testing.assert_close(
            A._delta(g2, o2),
            torch.einsum("bnhd,bnhd->bhn", g2.float(), o2.float()),
            rtol=1e-5, atol=1e-5)


def test_attention_autograd_runs_the_backward_kernels(cuda):
    q, k, v, biases = _attn_case(cuda, torch.float32, 2, 20, 30, 3, 64,
                                 [(2, 1, 1, 30)])
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    g = torch.randn(2, 20, 3, 64, device=cuda)
    before = (A.dq_launches, A.dkv_launches)
    got = torch.autograd.grad(A.attention_core(q, k, v, biases, 0.2),
                              (q, k, v), g)
    assert (A.dq_launches, A.dkv_launches) == (before[0] + 1, before[1] + 1)
    want = torch.autograd.grad(A.mha_reference(q, k, v, biases, 0.2),
                               (q, k, v), g)
    for gg, ww in zip(got, want):
        _close(gg, ww, torch.float32)


# float32 on the CUDA-core kernels: dq and the separate dbias kernel; bf16 on
# the TMA + wgmma route: one launch that returns dq and the position bias's
# gradient (a fused dbias output, no dbias launch)
@pytest.mark.parametrize("dtype,d", [(torch.float32, 32),
                                     (torch.bfloat16, 64)])
def test_attention_bias_grad_runs_the_dbias_kernel(cuda, dtype, d):
    q, k, v, biases = _attn_case(cuda, dtype, 2, 8, 8, 2, d,
                                 [(1, 2, 8, 8), "pad"])
    q.requires_grad_()
    bias = biases[0].requires_grad_()
    g = torch.randn(2, 8, 2, d, device=cuda).to(dtype)
    counters = ("dq_launches", "dkv_launches", "dbias_launches",
                "bwd_wgmma_launches", "bwd_dbias_outputs")
    before = [getattr(A, c) for c in counters]
    got = torch.autograd.grad(A.attention_core(q, k, v, biases), (q, bias),
                              g)
    # the padding mask needs no gradient; dq, no dk/dv
    wg = dtype == torch.bfloat16
    assert [getattr(A, c) - x for c, x in zip(counters, before)] == (
        [0, 0, 0, 1, 1] if wg else [1, 0, 1, 0, 0])
    want = torch.autograd.grad(A.mha_reference(q, k, v, biases), (q, bias),
                               g)
    for gg, ww in zip(got, want):
        _close(gg, ww, dtype)


# dbias of each bias against its plain version, from the same out and lse:
# both sum exact products of the same inputs in fp32, in other orders
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,n,m,h,d,bias_shapes,scale,causal", [
    (16, 72, 72, 32, 64, [(1, 32, 72, 72), "pad"], 1.0, False),  # T5 enc
    (2, 12, 12, 32, 64, ["relc", "pad"], 1.0, False),     # T5 decoder self
    (2, 40, 56, 4, 64, [(2, 1, 40, 56)], 0.125, False),   # (b, 1, n, m)
    (2, 70, 70, 3, 64, [(2, 3, 70, 70)], 0.125, True),    # full, causal
    (2, 9, 30, 3, 32, [(2, 1, 1, 30)], 0.3, False),       # pad, n != m
    (2, 20, 130, 3, 64, [(2, 3, 20, 1)], 0.3, False),     # key dim 1
    (2, 5, 3, 2, 16, [(1, 1, 1, 1)], 1.0, True),          # one scalar
    (1, 200, 200, 2, 88, [(1, 2, 200, 200)], 0.1, False),  # ragged tiles
])
def test_flash_dbias_matches_plain(cuda, dtype, b, n, m, h, d, bias_shapes,
                                   scale, causal):
    q, k, v, biases = _attn_case(cuda, dtype, b, n, m, h, d, bias_shapes)
    g = torch.tensor(np.random.default_rng(9).standard_normal((b, n, h, d)),
                     device=cuda).to(dtype)
    out, lse = A.flash_attention(q, k, v, biases, scale, causal)
    for i, bias in enumerate(biases):
        before = A.dbias_launches
        got = A.flash_attention_dbias(q, k, v, out, lse, g, biases, i, scale,
                                      causal)
        assert A.dbias_launches == before + 1
        want = A.flash_attention_dbias_ref(q, k, v, out, lse, g, biases, i,
                                           scale, causal)
        assert got.shape == want.shape == bias.shape
        assert got.dtype == torch.float32
        _close(got, want, dtype)


# the gradient of every bias in one backward call, in bf16: the biases that
# keep the query and key dims on the TMA + wgmma route come out of that
# kernel (stored, or summed over batch and heads in order by a pass); the
# others (a key dim of 1, a (b, 1, 1, m) mask, the mma.sync route's head
# dims) from the separate dbias kernel; each against its plain version
@pytest.mark.parametrize("b,n,m,h,d,bias_shapes,scale,causal", [
    (16, 72, 72, 32, 64, [(1, 32, 72, 72), "pad"], 1.0, False),  # T5 enc
    (1, 72, 72, 32, 64, [(1, 32, 72, 72), "pad"], 1.0, False),   # Fisher
    (2, 12, 12, 32, 64, ["relc", "pad"], 1.0, False),     # T5 decoder self
    (2, 40, 56, 4, 64, [(2, 1, 40, 56)], 0.125, False),   # (b, 1, n, m)
    (2, 70, 70, 3, 64, [(2, 3, 70, 70)], 0.125, True),    # full, causal
    (3, 130, 200, 2, 40, [(1, 1, 130, 200)], 0.1, True),  # ragged, causal
    (2, 9, 30, 3, 32, [(2, 1, 1, 30)], 0.3, False),       # pad, n != m
    (2, 20, 130, 3, 64, [(2, 3, 20, 1)], 0.3, False),     # key dim 1
    (1, 200, 200, 2, 88, [(1, 2, 200, 200)], 0.1, False),  # ragged tiles
    (2, 200, 200, 4, 128, [(1, 4, 200, 200)], 128 ** -0.5, True),  # d 128
    (2, 72, 72, 8, 128, [(2, 1, 72, 72)], 128 ** -0.5, False),  # LLaMA's
])
@pytest.mark.parametrize("need_qkv", [True, False])
def test_fused_dbias_matches_plain(cuda, b, n, m, h, d, bias_shapes, scale,
                                   causal, need_qkv):
    q, k, v, biases = _attn_case(cuda, torch.bfloat16, b, n, m, h, d,
                                 bias_shapes)
    g = torch.tensor(np.random.default_rng(9).standard_normal((b, n, h, d)),
                     device=cuda).to(torch.bfloat16)
    out, lse = A.flash_attention(q, k, v, biases, scale, causal)
    routes = [A.plan_dbias(A.plan(n, m, d), A._as_4d(x).shape, n, m)
              for x in biases]
    before = (A.bwd_dbias_outputs, A.dbias_launches)
    got = A.flash_attention_backward(q, k, v, out, lse, g, biases, scale,
                                     causal, need_qkv, need_qkv,
                                     dbias_of=range(len(biases)))
    assert (A.bwd_dbias_outputs - before[0], A.dbias_launches - before[1]) \
        == (routes.count(A.FUSED), routes.count(A.DBIAS))
    want = A.flash_attention_backward_ref(q, k, v, out, lse, g, biases,
                                          scale, causal,
                                          dbias_of=range(len(biases)))
    for i, (gg, ww) in enumerate(zip(got, want)):
        if i < 3 and not need_qkv:
            assert gg is None
            continue
        assert gg.shape == ww.shape
        _close(gg, ww, torch.bfloat16)


# dq, dk, dv and the fused dbias are summed in fixed orders (dq over the
# kv tiles, dbias over the batches): two identical calls are bit-equal
@pytest.mark.parametrize("b,n,m,h,d,bias_shapes,scale", [
    (16, 72, 72, 32, 64, [(1, 32, 72, 72), "pad"], 1.0),   # T5 encoder
    (1, 72, 72, 32, 64, [(1, 32, 72, 72), "pad"], 1.0),    # the Fisher's
    (8, 257, 257, 16, 88, [], 88 ** -0.5),                 # EVA ViT-g
    (4, 72, 72, 32, 128, [(4, 1, 72, 72)], 128 ** -0.5),   # LLaMA's
    (2, 200, 200, 4, 128, [(1, 4, 200, 200)], 128 ** -0.5),  # 4 kv tiles
])
def test_backward_two_calls_are_bit_equal(cuda, b, n, m, h, d, bias_shapes,
                                          scale):
    q, k, v, biases = _attn_case(cuda, torch.bfloat16, b, n, m, h, d,
                                 bias_shapes)
    g = torch.tensor(np.random.default_rng(9).standard_normal((b, n, h, d)),
                     device=cuda).to(torch.bfloat16)
    out, lse = A.flash_attention(q, k, v, biases, scale)
    dbias_of = (0,) if biases else ()
    one, two = (A.flash_attention_backward(q, k, v, out, lse, g, biases,
                                           scale, dbias_of=dbias_of)
                for _ in range(2))
    assert len(one) == 3 + len(dbias_of)
    for x, y in zip(one, two):
        assert torch.equal(x, y)


# ------------------------------------------- packed-mask and int8 kernels
# The packed kernel runs the bool kernel's tile loop and split-K: for the
# same W and mask its output is bit-equal to the bool kernel's.  The int8
# kernel's tolerance is the masked matmul's (the plain version sums the
# same exact products in another order).


def _packed_case(cuda, dtype, m, k, n, group, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(m, k, generator=g, device=cuda).to(dtype)
    w = (torch.randn(k, n, generator=g, device=cuda) * k ** -0.5).to(dtype)
    mask = torch.rand(k, n, generator=g, device=cuda) < 0.5
    return x, w, mask, BM.pack_mask(mask, group)


PACKED_SHAPES = [
    (20, 2048, 5120),      # beam decode T5 wi: split-K
    (20, 5120, 2048),      # beam decode T5 wo: splits start inside groups
    (1028, 1408, 4224),    # ViT qkv prefill (4 requests × 257), ragged M
    (33, 300, 13),         # nothing tiles: unvectorized loads, padded rows
    (7, 1001, 77),         # unvectorized loads, split-K
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("m,k,n", PACKED_SHAPES)
def test_masked_matmul_packed_matches_plain_and_bool(cuda, dtype, group, m,
                                                     k, n):
    x, w, mask, packed = _packed_case(cuda, dtype, m, k, n, group)
    before = ML.packed_launches
    got = ML.masked_matmul_packed(x, w, packed)
    assert ML.packed_launches == before + 1
    _close(got, ML.masked_matmul_packed_ref(x, w, packed), dtype)
    assert torch.equal(got, ML.masked_matmul(x, w, mask))


@pytest.mark.parametrize("group", [128, 256])
def test_masked_matmul_packed_grads_match_plain(cuda, group):
    x, w, _, packed = _packed_case(cuda, torch.float32, 50, 300, 72, group)
    gy = torch.randn(50, 72, device=cuda)
    leaves = [t.requires_grad_() for t in (x, w)]
    got = torch.autograd.grad(ML.masked_matmul_packed(x, w, packed), leaves,
                              gy)
    want = torch.autograd.grad(ML.masked_matmul_packed_ref(x, w, packed),
                               leaves, gy)
    for gg, ww in zip(got, want):
        _close(gg, ww, torch.float32)


def _int8_case(cuda, dtype, m, k, n, mask_kind, seed=0):
    x, w, mask, _ = _packed_case(cuda, torch.float32, m, k, n, 128, seed)
    q, scale = Q.quantize_weight(w)
    if mask_kind == "none":
        mask = None
    elif mask_kind.startswith("packed"):
        mask = BM.pack_mask(mask, int(mask_kind[6:]))
    return x.to(dtype), q, scale, mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mask_kind", ["none", "bool", "packed128",
                                       "packed256"])
@pytest.mark.parametrize("m,k,n", PACKED_SHAPES)
def test_int8_matmul_matches_plain(cuda, dtype, mask_kind, m, k, n):
    x, q, scale, mask = _int8_case(cuda, dtype, m, k, n, mask_kind)
    before = Q.int8_launches
    got = Q.int8_matmul(x, q, scale, mask)
    assert Q.int8_launches == before + 1
    assert got.dtype == dtype
    _close(got, Q.int8_matmul_ref(x, q, scale, mask), dtype)


def test_int8_matmul_packed_equals_bool_mask(cuda):
    """A packed mask and its bool form zero the same codes before the same
    sums: bit-equal outputs."""
    x, q, scale, mask = _int8_case(cuda, torch.bfloat16, 20, 5120, 2048,
                                   "bool")
    got = Q.int8_matmul(x, q, scale, BM.pack_mask(mask, 256))
    assert torch.equal(got, Q.int8_matmul(x, q, scale, mask))


def test_int8_matmul_grad_matches_plain(cuda):
    x, q, scale, mask = _int8_case(cuda, torch.float32, 30, 300, 40,
                                   "packed128")
    x.requires_grad_()
    gy = torch.randn(30, 40, device=cuda)
    got, = torch.autograd.grad(Q.int8_matmul(x, q, scale, mask), x, gy)
    want, = torch.autograd.grad(Q.int8_matmul_ref(x, q, scale, mask), x, gy)
    _close(got, want, torch.float32)


# ----------------------------------------------- the Hopper (wgmma) loop
# Wherever the output tiles fill the card without split-K, the bool,
# packed and sparse-LoRA matmuls run the TMA + wgmma loop (``ML.plan``);
# each case asserts through ``ML.wgmma_launches`` which loop it ran.  The
# ragged cases cut M, N and K inside a tile (N = 1296 leaves the last
# tile's second 64-column W box wholly out of bounds).  Tolerances as
# above; the packed kernel is bit-equal to the bool one on this loop too.

HOPPER_SHAPES = [
    (2000, 1408, 1392),    # ragged M and N
    (1600, 1000, 1296),    # ragged K; an all-out-of-bounds W box
    (1028, 1408, 4224),    # ViT qkv prefill (4 requests × 257)
    (9216, 5120, 2048),    # T5 wo calibration
    (32896, 1408, 6144),   # ViT fc1 calibration
]


def _loop_ran(before: int, m: int, k: int, n: int, rank: int = 0) -> str:
    """The loop ``plan`` gives the shape, checked against the counter."""
    loop = ML.plan(m, n, k, torch.cuda.get_device_properties(0)
                   .multi_processor_count, rank=rank)[0]
    assert ML.wgmma_launches - before == (loop == ML.WGMMA)
    return loop


@pytest.mark.parametrize("m,k,n", HOPPER_SHAPES)
def test_hopper_loop_matches_plain(cuda, m, k, n):
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, m, k, n, 128)
    before = ML.wgmma_launches
    got = ML.masked_matmul(x, w, mask)
    assert _loop_ran(before, m, k, n) == ML.WGMMA
    _close(got, ML.masked_matmul_ref(x, w, mask), torch.bfloat16)


@pytest.mark.parametrize("group", [128, 256])
@pytest.mark.parametrize("m,k,n", HOPPER_SHAPES)
def test_hopper_loop_packed_bit_equal_to_bool(cuda, group, m, k, n):
    x, w, mask, packed = _packed_case(cuda, torch.bfloat16, m, k, n, group)
    before = ML.wgmma_launches
    got = ML.masked_matmul_packed(x, w, packed)
    assert _loop_ran(before, m, k, n) == ML.WGMMA
    _close(got, ML.masked_matmul_packed_ref(x, w, packed), torch.bfloat16)
    assert torch.equal(got, ML.masked_matmul(x, w, mask))


def _lora_case(cuda, m, k, n, r, seed=0):
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, m, k, n, 128, seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    a = ((torch.rand(k, r, generator=g, device=cuda) * 2 - 1)
         * (6.0 / k) ** 0.5).bfloat16()
    b = (torch.randn(r, n, generator=g, device=cuda) * 0.05).bfloat16()
    return x, w, mask, a, b


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(2000, 1408, 1392), (1600, 1000, 1296),
                                   (8224, 1408, 6144), (2304, 2048, 5120)])
def test_hopper_loop_sparse_lora_matches_plain(cuda, r, m, k, n):
    x, w, mask, a, b = _lora_case(cuda, m, k, n, r)
    before = ML.wgmma_launches
    got = ML.sparse_lora_matmul(x, w, mask, a, b, 16.0 / r)
    assert _loop_ran(before, m, k, n, r) == ML.WGMMA
    _close(got, ML.sparse_lora_matmul_ref(x, w, mask, a, b, 16.0 / r),
           torch.bfloat16)


@pytest.mark.parametrize("r", [2, 4, 8])
def test_hopper_loop_sparse_lora_grads_match_plain(cuda, r):
    """The autograd Function's forward on the Hopper loop, its backward (the
    JAX VJP) against autograd through the plain version."""
    x, w, mask, a, b = _lora_case(cuda, 2100, 1408, 1392, r, seed=3)
    x = x.reshape(3, 700, 1408)
    gy = torch.randn(3, 700, 1392, device=cuda).bfloat16()
    leaves = [t.requires_grad_() for t in (x, a, b)]
    before = ML.wgmma_launches
    got = torch.autograd.grad(
        ML.sparse_lora_matmul(x, w, mask, a, b, 16.0 / r), leaves, gy)
    assert _loop_ran(before, 2100, 1408, 1392, r) == ML.WGMMA
    want = torch.autograd.grad(
        ML.sparse_lora_matmul_ref(x, w, mask, a, b, 16.0 / r), leaves, gy)
    for gg, ww in zip(got, want):
        _close(gg, ww, torch.bfloat16)


@pytest.mark.parametrize("m,k,n,loop", [
    (2000, 1408, 1392, ML.WGMMA),   # tiles fill the card, TMA-able
    (1000, 1408, 1400, ML.WMMA),    # N % 16 != 0: no TMA stride
    (20, 2048, 5120, ML.DECODE),    # decode: the cluster split-K kernel
])
def test_dispatch_picks_each_loop(cuda, m, k, n, loop):
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, m, k, n, 128)
    before, decode = ML.wgmma_launches, ML.decode_launches
    got = ML.masked_matmul(x, w, mask)
    assert _loop_ran(before, m, k, n) == loop
    assert ML.decode_launches - decode == (loop == ML.DECODE)
    _close(got, ML.masked_matmul_ref(x, w, mask), torch.bfloat16)
    # the WMMA loop forced at the same shape agrees too
    before = ML.wgmma_launches
    _close(ML.masked_matmul(x, w, mask, _loop=ML.WMMA),
           ML.masked_matmul_ref(x, w, mask), torch.bfloat16)
    assert ML.wgmma_launches == before


# ------------------------------------- the Hopper loop at prefill shapes
# Above decode-sized M every weight form runs the Hopper loop: unsplit
# where the output tiles fill the card, split-K across a cluster (the
# partials summed in rank order over distributed shared memory) where they
# do not.  The int8 form converts its codes in shared memory and scales the
# fp32 sum once.  Shapes: every prefill shape of the serving path, the
# under-filled training shapes, and ragged ones (K inside a split unit, N
# inside a tile, M of one row tile).

PREFILL_SHAPES = [(m, k, n) for name, m, k, n in CS.SERVE_SHAPES
                  + CS.INT8_UNMASKED_SHAPES if not name.endswith("_decode")]
# split-K (the last two ragged: K inside a split unit, N inside a tile)
SPLIT_SHAPES = [(288, 2048, 2048), (1028, 1408, 1408), (300, 1000, 1296),
                (100, 2056, 784)]
RAGGED_SHAPES = [(2000, 1000, 1296)] + SPLIT_SHAPES[2:]


def _planned(m, k, n, rank=0):
    return ML.plan(m, n, k, torch.cuda.get_device_properties(0)
                   .multi_processor_count, rank=rank)


@pytest.mark.parametrize("mask_kind", ["none", "bool", "packed128",
                                       "packed256"])
@pytest.mark.parametrize("m,k,n", PREFILL_SHAPES + RAGGED_SHAPES)
def test_int8_prefill_runs_the_hopper_loop(cuda, mask_kind, m, k, n):
    x, q, scale, mask = _int8_case(cuda, torch.bfloat16, m, k, n, mask_kind)
    before, wmma = ML.wgmma_launches, ML.wmma_launches
    got = Q.int8_matmul(x, q, scale, mask)
    assert ML.wgmma_launches == before + 1 and ML.wmma_launches == wmma
    assert _planned(m, k, n)[0] == ML.WGMMA
    _close(got, Q.int8_matmul_ref(x, q, scale, mask), torch.bfloat16)


@pytest.mark.parametrize("m,k,n", PREFILL_SHAPES + RAGGED_SHAPES)
def test_hopper_loop_int8_mask_bit_equal_to_zeroed_codes_and_forms(cuda, m,
                                                                    k, n):
    """int8 with a bool mask ≡ with its packed-128 and packed-256 words ≡
    without a mask on codes zeroed off it; the bf16 packed forms ≡ the bool
    one; split or not."""
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, m, k, n, 128)
    q, scale = Q.quantize_weight(w)
    want = Q.int8_matmul(x, q.masked_fill(~mask, 0), scale)
    assert torch.equal(Q.int8_matmul(x, q, scale, mask), want)
    bool_y = ML.masked_matmul(x, w, mask)
    for group in (128, 256):
        packed = BM.pack_mask(mask, group)
        assert torch.equal(Q.int8_matmul(x, q, scale, packed), want), group
        assert torch.equal(ML.masked_matmul_packed(x, w, packed), bool_y)


@pytest.mark.parametrize("form", ["bool", "packed128", "int8_packed128",
                                  "lora"])
@pytest.mark.parametrize("m,k,n", SPLIT_SHAPES)
def test_hopper_split_k_matches_plain_and_repeats_bit_equal(cuda, form, m, k,
                                                            n):
    """The split form of each weight form against its plain version, and
    two identical calls bit-equal (the cluster's ordered sum)."""
    splits = _planned(m, k, n, 4 if form == "lora" else 0)[1]
    assert splits > 1
    if form == "lora":
        x, w, mask, a, b = _lora_case(cuda, m, k, n, 4)
        call = lambda: ML.sparse_lora_matmul(x, w, mask, a, b, 4.0)  # noqa
        want = ML.sparse_lora_matmul_ref(x, w, mask, a, b, 4.0)
    else:
        x, w, mask, _ = _packed_case(cuda, torch.bfloat16, m, k, n, 128)
        call = lambda: _decode_call(form, x, w, mask)[0]  # noqa: E731
        want = _decode_call(form, x, w, mask)[1]
    before = ML.wgmma_launches
    one = call()
    assert ML.wgmma_launches == before + 1
    _close(one, want, torch.bfloat16)
    assert torch.equal(one, call())


@pytest.mark.parametrize("r", [2, 4, 8])
@pytest.mark.parametrize("m,k,n", [(384, 2048, 5120), (2304, 768, 768),
                                   (1024, 768, 3072)])
def test_hopper_loop_sparse_lora_training_shapes(cuda, r, m, k, n):
    """The T5 decoder's and the Q-Former's training shapes, split or not."""
    x, w, mask, a, b = _lora_case(cuda, m, k, n, r)
    before = ML.wgmma_launches
    got = ML.sparse_lora_matmul(x, w, mask, a, b, 16.0 / r)
    assert ML.wgmma_launches == before + 1
    _close(got, ML.sparse_lora_matmul_ref(x, w, mask, a, b, 16.0 / r),
           torch.bfloat16)


# ------------------------------------------------ the decode kernel
# At M ≤ 64 every weight form (bool, packed, int8 with any mask) runs
# csrc/matmul_decode.cu: swap-AB mma.sync, W streamed by TMA, K split
# across a cluster and summed in rank order.  So packed ≡ bool and
# int8-masked ≡ int8 on zeroed codes without a mask, bit for bit, and two
# identical calls agree bit for bit.  Ragged cases cut K inside a stage and
# a split unit (1000, 2056) and N inside a column tile (2064, 784).

DECODE_SHAPES = [(2048, 2048), (2048, 5120), (5120, 2048),   # T5 qkvo, wi, wo
                 (1000, 2064), (2056, 784)]
DECODE_FORMS = ["bool", "packed128", "packed256", "int8_none", "int8_bool",
                "int8_packed128"]


def _decode_call(form, x, w, mask):
    """The form's wrapper (public, so the card's route) on bf16 x, the
    float weight w and the bool mask: (output, plain version's output)."""
    if form == "bool":
        return (ML.masked_matmul(x, w, mask),
                ML.masked_matmul_ref(x, w, mask))
    if form.startswith("packed"):
        packed = BM.pack_mask(mask, int(form[6:]))
        return (ML.masked_matmul_packed(x, w, packed),
                ML.masked_matmul_packed_ref(x, w, packed))
    q, scale = Q.quantize_weight(w)
    kind = form[5:]
    mk = {"none": None, "bool": mask}.get(kind)
    if kind.startswith("packed"):
        mk = BM.pack_mask(mask, int(kind[6:]))
    return Q.int8_matmul(x, q, scale, mk), Q.int8_matmul_ref(x, q, scale, mk)


@pytest.mark.parametrize("form", DECODE_FORMS)
@pytest.mark.parametrize("m", [1, 7, 20, 64])
@pytest.mark.parametrize("k,n", DECODE_SHAPES)
def test_decode_kernel_matches_plain(cuda, form, m, k, n):
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, m, k, n, 128)
    before = ML.decode_launches
    got, want = _decode_call(form, x, w, mask)
    assert ML.decode_launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (m, n)
    _close(got, want, torch.bfloat16)


def test_decode_kernel_lm_head_int8(cuda):
    """The LM head at decode: int8 without a mask, 502 column tiles, one
    split."""
    x, w, _, _ = _packed_case(cuda, torch.bfloat16, 20, 2048, 32128, 128)
    q, scale = Q.quantize_weight(w)
    before = ML.decode_launches
    got = Q.int8_matmul(x, q, scale)
    assert ML.decode_launches == before + 1
    _close(got, Q.int8_matmul_ref(x, q, scale), torch.bfloat16)


@pytest.mark.parametrize("m", [1, 20, 64])
@pytest.mark.parametrize("k,n", DECODE_SHAPES)
def test_decode_kernel_packed_bit_equal_to_bool(cuda, m, k, n):
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, m, k, n, 128)
    want = ML.masked_matmul(x, w, mask)
    for group in (128, 256):
        got = ML.masked_matmul_packed(x, w, BM.pack_mask(mask, group))
        assert torch.equal(got, want), group


@pytest.mark.parametrize("kind", ["bool", "packed128", "packed256"])
@pytest.mark.parametrize("k,n", DECODE_SHAPES)
def test_decode_kernel_int8_mask_bit_equal_to_zeroed_codes(cuda, kind, k, n):
    """The serving form: codes zeroed off the mask, no mask, the same
    products in the same order."""
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, 20, k, n, 128)
    q, scale = Q.quantize_weight(w)
    mk = mask if kind == "bool" else BM.pack_mask(mask, int(kind[6:]))
    got = Q.int8_matmul(x, q, scale, mk)
    zeroed = q.masked_fill(~mask, 0)
    assert torch.equal(got, Q.int8_matmul(x, zeroed, scale))


@pytest.mark.parametrize("form", ["bool", "packed128", "int8_packed128"])
def test_decode_kernel_two_calls_are_bit_equal(cuda, form):
    """The cluster sums the split partials in rank order: no atomics."""
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, 20, 5120, 2048, 128)
    one = _decode_call(form, x, w, mask)[0]
    two = _decode_call(form, x, w, mask)[0]
    assert torch.equal(one, two)


@pytest.mark.parametrize("form", ["bool", "packed128", "int8_packed128"])
def test_decode_shape_forced_wmma_loop_matches_plain(
        cuda, form):
    """``_loop=WMMA`` at a decode shape runs the WMMA loop, within the
    tolerance of the same plain version."""
    x, w, mask, _ = _packed_case(cuda, torch.bfloat16, 20, 2048, 5120, 128)
    decode, wmma = ML.decode_launches, ML.wmma_launches
    if form == "bool":
        got = ML.masked_matmul(x, w, mask, _loop=ML.WMMA)
    elif form == "packed128":
        got = ML.masked_matmul_packed(x, w, BM.pack_mask(mask, 128),
                                      _loop=ML.WMMA)
    else:
        q, scale = Q.quantize_weight(w)
        got = Q.int8_matmul(x, q, scale, BM.pack_mask(mask, 128),
                            _loop=ML.WMMA)
    assert ML.decode_launches == decode
    assert ML.wmma_launches == wmma + 1
    _close(got, _decode_call(form, x, w, mask)[1], torch.bfloat16)
