"""The attention forward's and backward's dispatch (``ops/attention
.plan_forward`` with ``flash_attention``, ``plan`` with
``flash_attention_backward``) on the CPU: which route a call takes — the
bf16 TMA + wgmma kernel, the mma.sync kernels or the float32 ones — from
the dtype, head dim and alignment alone; which entry points a call reaches,
with which strides and bias pointers, and with which gradients switched
off; the launch counters; the internal ``_impl`` argument; and the whole
backward's bound.  The kernels themselves run only on the card
(``tests/test_torch_cuda_kernels.py``)."""

import pytest
import torch

import chip_smoke as CS
from vlm_compression_tpu_torch.ops import attention as A

# (case, n, m, d, bf16, aligned, route)
CASES = [(name, n, m, d, True, True, A.WGMMA)
         for name, b, n, m, h, d, kinds, scale in CS.BWD_SHAPES]
CASES += [
    ("ragged_200", 200, 200, 88, True, True, A.WGMMA),
    ("causal_n_gt_m", 9, 5, 64, True, True, A.WGMMA),
    ("d_40", 72, 72, 40, True, True, A.WGMMA),
    # what the TMA + wgmma kernel does not take: a head dim off 8 (a
    # 16-byte TMA stride), at most 32 or above 96; a misaligned view
    ("d_100", 72, 72, 100, True, True, A.MMA),
    ("d_32", 72, 72, 32, True, True, A.MMA),
    ("d_128", 72, 72, 128, True, True, A.MMA),
    ("misaligned", 257, 257, 88, True, False, A.MMA),
    # float32: the CUDA-core kernels at every shape
    ("fp32_vit", 257, 257, 88, False, True, A.FP32),
    ("fp32_t5", 72, 72, 64, False, True, A.FP32),
]


@pytest.mark.parametrize("case,n,m,d,bf16,aligned,route", CASES,
                         ids=[c[0] for c in CASES])
def test_plan_picks_the_route(case, n, m, d, bf16, aligned, route):
    assert A.plan(n, m, d, bf16=bf16, aligned=aligned) == route


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def test_tma_alignment_of_views():
    """q, k, v as views of a fused (b, n, 3, h, d) projection qualify; a
    view off a 16-byte boundary or with a row stride off 16 bytes does
    not."""
    qkv = _bf16(2, 257, 3, 16, 88)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert A._tma_aligned(q, k, v)
    flat = _bf16(2 * 257 * 16 * 88 + 1)
    off = flat[1:].view(2, 257, 16, 88)           # base 2 bytes off
    assert not A._tma_aligned(off)
    odd = _bf16(2, 257, 16, 100)[..., :88]        # row stride 200 bytes
    assert not A._tma_aligned(odd)


class _Lib:
    """Stands in for the kernel libraries: records each entry point's
    call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    lib = _Lib()
    monkeypatch.setattr(A._cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(A._cuda, "library", lambda name: lib)
    monkeypatch.setattr(A, "_on_card", lambda t: True)
    return lib


def _case(b, n, m, h, d, dtype=torch.bfloat16):
    q = torch.zeros(b, n, h, d, dtype=dtype)
    k = torch.zeros(b, m, h, d, dtype=dtype)
    v = torch.zeros(b, m, h, d, dtype=dtype)
    lse = torch.zeros(b, h, n)
    return q, k, v, q.clone(), lse, q.clone()


def _counts():
    return (A.bwd_wgmma_launches, A.dq_launches, A.dkv_launches,
            A.delta_launches)


@pytest.mark.parametrize("need_dq,need_dkv", [(True, True), (True, False),
                                              (False, True)])
def test_the_wgmma_route_is_one_launch_with_null_outputs(fake_card, need_dq,
                                                         need_dkv):
    """One entry point launches the whole backward; a gradient not asked
    for is a null output pointer (and, for dq, a null workspace)."""
    args = _case(2, 257, 257, 4, 88)
    before = _counts()
    dq, dk, dv = A.flash_attention_backward(*args, scale=0.1,
                                            need_dq=need_dq,
                                            need_dkv=need_dkv)
    (called, cargs), = fake_card.calls
    assert called == "flash_attention_bwd_wgmma"
    ws, dq_p, dk_p, dv_p = cargs[8:12]
    assert (ws is None, dq_p is None) == (not need_dq, not need_dq)
    assert (dk_p is None, dv_p is None) == (not need_dkv, not need_dkv)
    assert (dq is None, dk is None, dv is None) == (
        not need_dq, not need_dkv, not need_dkv)
    # 23 strides: q, k, v, bias0, bias1, g, out; then b, n, m, h, d
    assert len(cargs[14]) == 23 and cargs[15:20] == (2, 257, 257, 4, 88)
    after = _counts()
    assert after == (before[0] + 1, before[1], before[2], before[3])


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 100),
                                     (torch.float32, 88)])
def test_the_other_routes_take_delta_from_the_pre_pass(fake_card, dtype, d):
    args = _case(2, 72, 72, 4, d, dtype)
    before = _counts()
    A.flash_attention_backward(*args)
    assert [c for c, _ in fake_card.calls] == [
        "flash_attention_bwd_delta", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"]
    # the pre-pass's dtype flag and the kernels' take the tensors' dtype
    assert fake_card.calls[0][1][0] == fake_card.calls[1][1][0] == int(
        dtype == torch.bfloat16)
    assert _counts() == (before[0], before[1] + 1, before[2] + 1,
                         before[3] + 1)


def test_the_dbias_wrapper_takes_delta_from_the_pre_pass(fake_card):
    q, k, v, out, lse, g = _case(2, 72, 72, 4, 64)
    bias = torch.zeros(1, 4, 72, 72)
    A.flash_attention_dbias(q, k, v, out, lse, g, [bias], 0)
    assert [c for c, _ in fake_card.calls] == [
        "flash_attention_bwd_delta", "flash_attention_bwd_dbias"]


def test_impl_forces_the_mma_route(fake_card):
    args = _case(2, 257, 257, 4, 88)
    A.flash_attention_backward(*args, _impl=A.MMA)
    assert [c for c, _ in fake_card.calls] == [
        "flash_attention_bwd_delta", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"]


@pytest.mark.parametrize("dtype,d,impl", [(torch.float32, 88, A.WGMMA),
                                          (torch.float32, 88, A.MMA),
                                          (torch.bfloat16, 100, A.WGMMA),
                                          (torch.bfloat16, 88, "fp32")])
def test_impl_raises_where_the_route_cannot_take_the_call(fake_card, dtype,
                                                          d, impl):
    args = _case(2, 72, 72, 4, d, dtype)
    before = _counts()
    with pytest.raises(ValueError, match="cannot take this call"):
        A.flash_attention_backward(*args, _impl=impl)
    assert fake_card.calls == [] and _counts() == before


@pytest.mark.parametrize("impl", [A.WGMMA, A.MMA])
def test_impl_raises_on_a_cpu_tensor(impl):
    args = _case(2, 72, 72, 4, 64)
    before = _counts()
    with pytest.raises(ValueError, match="unsupported device"):
        A.flash_attention_backward(*args, _impl=impl)
    assert _counts() == before


@pytest.mark.parametrize("b,n,m,h,d,biases", [
    (32, 257, 257, 16, 88, []),                          # ViT self
    (32, 72, 72, 32, 64, [(1, 32, 72, 72), (32, 1, 1, 72)]),   # T5 encoder
    (32, 12, 72, 32, 64, [(32, 1, 1, 72)]),              # T5 cross
])
def test_whole_backward_bound(b, n, m, h, d, biases):
    """Five products, 10·b·h·n·m·d operations at 989 TFLOP/s, against q,
    k, v, g, lse, delta and the biases read once and dq, dk, dv written
    once at 3.35 TB/s: the larger."""
    q = torch.zeros(b, n, h, d, dtype=torch.bfloat16)
    k = torch.zeros(b, m, h, d, dtype=torch.bfloat16)
    bs = [torch.zeros(s) for s in biases]
    ms, by = CS.flash_bwd_bound_ms(q, k, k, bs)
    flops = 10.0 * b * h * n * m * d
    nbytes = 2 * (2 * b * n * h * d + 2 * b * m * h * d) \
        + 8 * b * h * n + sum(4 * t.numel() for t in bs) \
        + 2 * (b * n * h * d + 2 * b * m * h * d)
    want = 1e3 * max(flops / 989e12, nbytes / 3.35e12)
    assert ms == pytest.approx(want, rel=1e-12)
    assert by == ("operations" if flops / 989e12 >= nbytes / 3.35e12
                  else "bytes")
    if (n, d) == (257, 88):   # the ViT's: its bytes, 163.2 MB
        assert by == "bytes" and ms == pytest.approx(0.048706, rel=1e-4)


# ------------------------------------------------------------- the forward
# (case, n, m, d, bf16, aligned, route) for ``plan_forward``: every shape
# of chip_smoke.py's FLASH_SHAPES (the decode steps, n = 1, included) and
# what the TMA + wgmma kernel does not take
FWD_CASES = [(name, n, m, d, True, True, A.WGMMA)
             for name, b, n, m, h, d, kinds, scale in CS.FLASH_SHAPES]
FWD_CASES += [
    ("vit_d88", 257, 257, 88, True, True, A.WGMMA),
    ("t5_qformer_d64", 72, 72, 64, True, True, A.WGMMA),
    ("decode_n1", 1, 10, 64, True, True, A.WGMMA),
    ("ragged_130_200", 130, 200, 88, True, True, A.WGMMA),
    ("d_32", 72, 72, 32, True, True, A.MMA),
    ("d_100", 72, 72, 100, True, True, A.MMA),
    ("d_128", 72, 72, 128, True, True, A.MMA),
    ("misaligned", 257, 257, 88, True, False, A.MMA),
    ("fp32_vit", 257, 257, 88, False, True, A.FP32),
    ("fp32_decode", 1, 10, 64, False, True, A.FP32),
]


@pytest.mark.parametrize("case,n,m,d,bf16,aligned,route", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
def test_plan_forward_picks_the_route(case, n, m, d, bf16, aligned, route):
    assert A.plan_forward(n, m, d, bf16=bf16, aligned=aligned) == route


@pytest.mark.parametrize("n,wgs", [(1, 1), (32, 1), (64, 1), (72, 1),
                                   (128, 1), (129, 3), (257, 3)])
def test_forward_block_rows(n, wgs):
    """One consumer warpgroup (64 query rows) a block up to n = 128, three
    above when no bias is added; one wherever a bias is."""
    assert A._fwd_wgs(n, False) == wgs
    assert A._fwd_wgs(n, True) == 1


def _fwd_counts():
    return A.launches, A.fwd_wgmma_launches


def _t5_biases(b, n, m, h):
    rel = torch.zeros(1, h, n, m)
    pad = torch.zeros(b, 1, 1, m)
    return [rel, pad]


@pytest.mark.parametrize("b,n,m,h,d,with_bias", [
    (2, 257, 257, 4, 88, False),     # ViT self
    (2, 72, 72, 4, 64, True),        # T5 encoder: position bias + padding
    (5, 1, 10, 4, 64, True),         # decode step
])
def test_the_forward_wgmma_route_is_one_launch(fake_card, b, n, m, h, d,
                                              with_bias):
    """One call of the TMA + wgmma entry point per forward, with the 17
    strides (q, k, v, then each bias's, 0 on its broadcast axes), the two
    bias pointers, the shape, scale, causal flag and the block's consumer
    warpgroups."""
    q, k, v = _case(b, n, m, h, d)[:3]
    biases = _t5_biases(b, n, m, h) if with_bias else []
    before = _fwd_counts()
    out, lse = A.flash_attention(q, k, v, biases, scale=0.125, causal=True)
    (called, cargs), = fake_card.calls
    assert called == "flash_attention_fwd_wgmma"
    assert cargs[:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), lse.data_ptr())
    want_ptrs = [t.data_ptr() for t in biases] + [None] * (2 - len(biases))
    assert list(cargs[5:7]) == want_ptrs
    strides = list(cargs[7])
    assert strides[:9] == [*q.stride()[:3], *k.stride()[:3],
                           *v.stride()[:3]]
    if with_bias:
        # rel (1, h, n, m): 0 on size-1 axes; pad (b, 1, 1, m)
        assert strides[9:] == [0, m * n, m if n > 1 else 0, 1, m, 0, 0, 1]
    else:
        assert strides[9:] == [0] * 8
    assert cargs[8:13] == (b, n, m, h, d)
    assert cargs[13] == pytest.approx(0.125) and cargs[14] == 1
    assert cargs[15] == A._fwd_wgs(n, with_bias)
    assert out.shape == q.shape and lse.shape == (b, h, n)
    assert _fwd_counts() == (before[0] + 1, before[1] + 1)


def _misaligned(b, n, h, d):
    flat = torch.zeros(b * n * h * d + 1, dtype=torch.bfloat16)
    return flat[1:].view(b, n, h, d)             # base 2 bytes off


@pytest.mark.parametrize("what", ["bf16_d100", "fp32", "misaligned"])
def test_the_forward_other_routes(fake_card, what):
    """bf16 the TMA + wgmma kernel does not take, and float32, go to the
    entry point of flash_attention.cu with their dtype flag."""
    if what == "bf16_d100":
        q, k, v = _case(2, 72, 72, 4, 100)[:3]
    elif what == "fp32":
        q, k, v = _case(2, 257, 257, 4, 88, torch.float32)[:3]
    else:
        q = _misaligned(2, 257, 4, 88)
        k = v = torch.zeros(2, 257, 4, 88, dtype=torch.bfloat16)
    before = _fwd_counts()
    A.flash_attention(q, k, v)
    (called, cargs), = fake_card.calls
    assert called == "flash_attention_fwd"
    assert cargs[0] == int(what != "fp32")
    assert _fwd_counts() == (before[0] + 1, before[1])


def test_forward_impl_forces_the_mma_route(fake_card):
    q, k, v = _case(2, 257, 257, 4, 88)[:3]
    before = _fwd_counts()
    A.flash_attention(q, k, v, _impl=A.MMA)
    assert [c for c, _ in fake_card.calls] == ["flash_attention_fwd"]
    A.flash_attention(q, k, v, _impl=A.WGMMA)
    assert [c for c, _ in fake_card.calls][1:] == [
        "flash_attention_fwd_wgmma"]
    assert _fwd_counts() == (before[0] + 2, before[1] + 1)


@pytest.mark.parametrize("what,impl", [("fp32", A.WGMMA), ("fp32", A.MMA),
                                       ("bf16_d100", A.WGMMA),
                                       ("misaligned", A.WGMMA),
                                       ("bf16", "fp32")])
def test_forward_impl_raises_where_the_route_cannot_take_the_call(
        fake_card, what, impl):
    if what == "misaligned":
        q = _misaligned(2, 72, 4, 64)
        k = v = torch.zeros(2, 72, 4, 64, dtype=torch.bfloat16)
    else:
        dtype = torch.float32 if what == "fp32" else torch.bfloat16
        q, k, v = _case(2, 72, 72, 4, 100 if what == "bf16_d100" else 64,
                        dtype)[:3]
    before = _fwd_counts()
    with pytest.raises(ValueError, match="cannot take this call"):
        A.flash_attention(q, k, v, _impl=impl)
    assert fake_card.calls == [] and _fwd_counts() == before


@pytest.mark.parametrize("impl", [A.WGMMA, A.MMA])
def test_forward_impl_raises_on_a_cpu_tensor(impl):
    q, k, v = _case(2, 72, 72, 4, 64)[:3]
    before = _fwd_counts()
    with pytest.raises(ValueError, match="unsupported device"):
        A.flash_attention(q, k, v, _impl=impl)
    assert _fwd_counts() == before
