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

# (case, n, m, d, bf16, aligned, route): every training shape on TMA +
# wgmma, LLaMA's d = 128 included
CASES = [(name, n, m, d, True, True, A.WGMMA)
         for name, b, n, m, h, d, kinds, scale in CS.BWD_SHAPES]
CASES += [
    ("ragged_200", 200, 200, 88, True, True, A.WGMMA),
    ("causal_n_gt_m", 9, 5, 64, True, True, A.WGMMA),
    ("d_40", 72, 72, 40, True, True, A.WGMMA),
    ("m_576", 72, 576, 64, True, True, A.WGMMA),     # nine kv tiles
    # LLaMA's head dim, and those that pad to it (DP = 128)
    ("d_128", 72, 72, 128, True, True, A.WGMMA),
    ("d_104", 72, 72, 104, True, True, A.WGMMA),
    ("d_120", 200, 130, 120, True, True, A.WGMMA),
    # what the TMA + wgmma kernel does not take: a head dim off 8 (a
    # 16-byte TMA stride), at most 32 or above 128; a misaligned view
    ("d_100", 72, 72, 100, True, True, A.MMA),
    ("d_32", 72, 72, 32, True, True, A.MMA),
    ("misaligned", 257, 257, 88, True, False, A.MMA),
    ("misaligned_d128", 72, 72, 128, True, False, A.MMA),
    # float32: the CUDA-core kernels at every shape
    ("fp32_vit", 257, 257, 88, False, True, A.FP32),
    ("fp32_t5", 72, 72, 64, False, True, A.FP32),
    ("fp32_d128", 72, 72, 128, False, True, A.FP32),
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


@pytest.mark.parametrize("b,n,m,h,d,route", [(2, 257, 257, 4, 88, A.WGMMA),
                                              (2, 72, 72, 4, 128, A.WGMMA),
                                              (2, 72, 72, 4, 100, A.MMA)])
def test_backward_calls_are_tallied_by_shape_and_route(fake_card, b, n, m, h,
                                                       d, route):
    """One backward call counts once under (b, n, m, h, d, route) on either
    route (mma.sync: its dq and dk/dv launches together), which
    chip_smoke.py reads with ``read_shapes`` and holds to its backward
    shapes with ``check_shapes``."""
    CS.reset_counts()
    A.flash_attention_backward(*_case(b, n, m, h, d), scale=0.1)
    A.flash_attention_backward(*_case(b, n, m, h, d), scale=0.1,
                               need_dkv=False)
    assert CS.read_shapes()["attention_bwd"] == {(b, n, m, h, d, route): 2}
    CS.reset_counts()
    assert A.bwd_shape_launches == {}


# (case, b, n, m, h, d): the TMA + wgmma backward's dq workspace, an fp32
# slab a kv tile at every shape — the retrain's batch 32 (every
# BWD_SHAPES shape that route takes), the diagonal Fisher's batch 1,
# batches between, one kv tile and nine
SLAB_CASES = [(name, b, n, m, h, d)
              for name, b, n, m, h, d, kinds, scale in CS.BWD_SHAPES
              if A.plan(n, m, d) == A.WGMMA]
SLAB_CASES += [
    ("fisher_vit", 1, 257, 257, 16, 88),
    ("fisher_qformer_cross", 1, 32, 257, 12, 64),
    ("fisher_t5_encoder", 1, 72, 72, 32, 64),
    ("fisher_t5_decoder_self", 1, 12, 12, 32, 64),   # one kv tile
    ("fisher_t5_decoder_cross", 1, 12, 72, 32, 64),
    ("vit_b8", 8, 257, 257, 16, 88),
    ("t5_b16", 16, 72, 72, 32, 64),
    ("m_576", 2, 72, 576, 4, 64),                     # nine kv tiles
]


def _allocations(monkeypatch):
    """Record the shape and dtype of every torch.empty call."""
    made, empty = [], torch.empty

    def spy(*shape, **kw):
        made.append((tuple(shape[0]) if len(shape) == 1 else shape,
                     kw.get("dtype")))
        return empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", spy)
    return made


@pytest.mark.parametrize("case,b,n,m,h,d", SLAB_CASES,
                         ids=[c[0] for c in SLAB_CASES])
def test_the_dq_workspace_is_a_slab_a_kv_tile(fake_card, monkeypatch, case,
                                              b, n, m, h, d):
    """The entry point gets the workspace of (kv tiles, b, h, n rounded up
    to 64, d padded to 64, 96 or 128) float32, whatever the batch: each kv
    tile stores its dQ into its own slab and the cast sums them in kv
    order."""
    args = _case(b, n, m, h, d)
    made = _allocations(monkeypatch)
    A.flash_attention_backward(*args, scale=0.1)
    (called, cargs), = fake_card.calls
    assert called == "flash_attention_bwd_wgmma" and cargs[8] is not None
    slabs = (-(-m // 64), b, h, -(-n // 64) * 64,
             64 if d <= 64 else 96 if d <= 96 else 128)
    assert (slabs, torch.float32) in made


@pytest.mark.parametrize("n,m,d", [(72, 72, 128), (200, 130, 128),
                                   (72, 72, 104)])
def test_the_dq_slab_is_128_wide_past_d_96(fake_card, monkeypatch, n, m, d):
    """At LLaMA's d = 128 (and a d that pads to it) the slab's last dim is
    128, the kernel's DP there: a slab of 96 would be written past."""
    args = _case(2, n, m, 4, d)
    made = _allocations(monkeypatch)
    A.flash_attention_backward(*args, scale=0.1)
    (called, cargs), = fake_card.calls
    assert called == "flash_attention_bwd_wgmma"
    assert A._head_pad(d) == 128
    slabs = [shape for shape, dtype in made
             if dtype == torch.float32 and len(shape) == 5]
    assert slabs == [(-(-m // 64), 2, 4, -(-n // 64) * 64, 128)]


@pytest.mark.parametrize("b", [1, 32])
def test_the_wgmma_call_carries_no_scratch_without_dbias(fake_card, b):
    """Without a bias gradient, the entry point's dbias outputs, their
    scratch and keep bits are null and 0, at the Fisher's batch and the
    retrain's alike."""
    args = _case(b, 257, 257, 16, 88)
    A.flash_attention_backward(*args, scale=0.1)
    (called, cargs), = fake_card.calls
    # ... scale, causal, dbias0, dbias1, their scratch, keep, stream
    assert cargs[22:27] == (None, None, None, None, 0)
    assert len(cargs) == 28


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
    ("d_128", 72, 72, 128, True, True, A.WGMMA),
    ("llama_decode_n1", 1, 55, 128, True, True, A.WGMMA),
    ("d_104", 72, 72, 104, True, True, A.WGMMA),
    ("d_120", 44, 55, 120, True, True, A.WGMMA),
    ("d_32", 72, 72, 32, True, True, A.MMA),
    ("d_100", 72, 72, 100, True, True, A.MMA),
    ("d_136", 72, 72, 136, True, True, A.MMA),
    ("misaligned", 257, 257, 88, True, False, A.MMA),
    ("misaligned_d128", 44, 55, 128, True, False, A.MMA),
    ("fp32_vit", 257, 257, 88, False, True, A.FP32),
    ("fp32_decode", 1, 10, 64, False, True, A.FP32),
    ("fp32_d128", 1, 55, 128, False, True, A.FP32),
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
    assert A._fwd_wgs(n, False, 88) == wgs
    assert A._fwd_wgs(n, True, 88) == 1


@pytest.mark.parametrize("d,wgs", [(88, 3), (96, 3), (104, 1), (128, 1)])
def test_forward_block_rows_at_d_128(d, wgs):
    """A bias-free call above n = 128 takes three consumer warpgroups at
    d ≤ 96 and one past it: three Q and O tiles of DP = 128 and the kv ring
    do not fit a block's shared memory, and the kernel refuses them."""
    assert A._fwd_wgs(257, False, d) == wgs
    assert A._fwd_wgs(257, True, d) == 1


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
    (2, 72, 72, 4, 128, True),       # LLaMA's head dim
    (5, 1, 55, 4, 128, True),        # LLaMA's decode step
    (2, 257, 257, 4, 128, False),    # bias-free past n = 128: one warpgroup
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
    assert cargs[15] == A._fwd_wgs(n, with_bias, d)
    assert cargs[15] == (3 if n > 128 and not with_bias and d <= 96 else 1)
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


# -------------------------------------------------------------- the dbias
# (case, bias shape as a function of (b, h, n, m), route, where its
# gradient comes from): the TMA + wgmma backward returns the gradient of a
# bias that keeps the query and key dims; the separate dbias kernel takes
# every other bias, and every bias off that route
DBIAS_PLANS = [
    ("rel_1hnm", lambda b, h, n, m: (1, h, n, m), A.WGMMA, A.FUSED),
    ("bn_b1nm", lambda b, h, n, m: (b, 1, n, m), A.WGMMA, A.FUSED),
    ("full_bhnm", lambda b, h, n, m: (b, h, n, m), A.WGMMA, A.FUSED),
    ("one_11nm", lambda b, h, n, m: (1, 1, n, m), A.WGMMA, A.FUSED),
    ("pad_b11m", lambda b, h, n, m: (b, 1, 1, m), A.WGMMA, A.DBIAS),
    ("keyd1_bhn1", lambda b, h, n, m: (b, h, n, 1), A.WGMMA, A.DBIAS),
    ("rel_on_mma", lambda b, h, n, m: (1, h, n, m), A.MMA, A.DBIAS),
    ("rel_on_fp32", lambda b, h, n, m: (1, h, n, m), A.FP32, A.DBIAS),
]


@pytest.mark.parametrize("case,shape,route,where", DBIAS_PLANS,
                         ids=[c[0] for c in DBIAS_PLANS])
def test_plan_dbias_picks_where_the_gradient_comes_from(case, shape, route,
                                                        where):
    assert A.plan_dbias(route, shape(4, 8, 72, 72), 72, 72) == where


def _dbias_counts():
    return (A.bwd_wgmma_launches, A.bwd_dbias_outputs, A.dbias_launches,
            A.delta_launches, A.dq_launches, A.dkv_launches)


@pytest.mark.parametrize("kind", ["rel", "bn", "full", "full_causal",
                                  "rel_b1"])
@pytest.mark.parametrize("need_qkv", [True, False])
def test_the_fused_dbias_is_an_output_of_the_wgmma_launch(fake_card,
                                                         monkeypatch, kind,
                                                         need_qkv):
    """A bf16 backward on the TMA + wgmma route with a bias that keeps the
    query and key dims: one entry-point call (its pre-pass, main kernel,
    cast and, for a bias it sums over batch or heads, the sum pass) with
    the dbias pointer set, the bias's keep bits and, where it sums, a
    (b, h, n, m) float32 scratch; no call of the separate dbias kernel;
    with no dq, dk, dv asked for the call carries null outputs for them."""
    b = 1 if kind == "rel_b1" else 2
    h, n, m, d = 4, 72, 72, 64
    q, k, v, out, lse, g = _case(b, n, m, h, d)
    shape = {"rel": (1, h, n, m), "rel_b1": (1, h, n, m), "bn": (b, 1, n, m),
             "full": (b, h, n, m), "full_causal": (b, h, n, m)}[kind]
    pad = torch.zeros(b, 1, 1, m)
    before = _dbias_counts()
    made = _allocations(monkeypatch)
    dq, dk, dv, db = A.flash_attention_backward(
        q, k, v, out, lse, g, [torch.zeros(shape), pad], 0.125,
        kind == "full_causal", need_qkv, need_qkv, dbias_of=[0])
    (called, cargs), = fake_card.calls
    assert called == "flash_attention_bwd_wgmma"
    assert db.shape == shape and db.dtype == torch.float32
    assert (dq is None, dk is None) == (not need_qkv, not need_qkv)
    assert (cargs[9] is None, cargs[10] is None) == (not need_qkv,
                                                     not need_qkv)
    # ... scale, causal, dbias0, dbias1, their scratch, keep, stream
    db0, db1, ws0, ws1, keep = cargs[22:27]
    assert db0 == db.data_ptr() and db1 is None and ws1 is None
    kb, kh = shape[0] == b, shape[1] == h
    assert keep == kb | kh << 1
    # summed over batch or heads: a scratch of every (batch, head)'s tiles
    summed = (1 if kb else b) * (1 if kh else h) > 1
    assert (ws0 is not None) == summed
    assert made.count(((b, h, n, m), torch.float32)) == \
        (shape == (b, h, n, m)) + summed
    after = _dbias_counts()
    assert [x - y for x, y in zip(after, before)] == [1, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("what", ["pad", "keyd1", "fp32", "bf16_d100",
                                  "impl_mma"])
def test_other_bias_gradients_take_the_dbias_kernel(fake_card, what):
    """fp32, the mma.sync route (a head dim the TMA + wgmma kernel does
    not hold, or forced) and biases without a query or key dim: the
    separate dbias kernel, with its own delta pre-pass, beside the
    backward's launches."""
    dtype = torch.float32 if what == "fp32" else torch.bfloat16
    d = 100 if what == "bf16_d100" else 64
    b, h, n, m = 2, 4, 72, 72
    q, k, v, out, lse, g = _case(b, n, m, h, d, dtype)
    bias = torch.zeros({"pad": (b, 1, 1, m),
                        "keyd1": (b, h, n, 1)}.get(what, (1, h, n, m)))
    before = _dbias_counts()
    *_, db = A.flash_attention_backward(
        q, k, v, out, lse, g, [bias], dbias_of=(0,),
        _impl=A.MMA if what == "impl_mma" else None)
    calls = [c for c, _ in fake_card.calls]
    assert calls[-2:] == ["flash_attention_bwd_delta",
                          "flash_attention_bwd_dbias"]
    wg = what in ("pad", "keyd1")
    assert calls[:-2] == (["flash_attention_bwd_wgmma"] if wg else [
        "flash_attention_bwd_delta", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv"])
    if wg:   # the backward's call carries no dbias
        assert fake_card.calls[0][1][22:27] == (None, None, None, None, 0)
    assert db.shape == bias.shape
    after = _dbias_counts()
    assert [x - y for x, y in zip(after, before)][:3] == [int(wg), 0, 1]


def test_a_dbias_only_call_off_the_fused_route_launches_no_backward(
        fake_card):
    """Only the gradient of a padding mask asked for: no backward launch,
    the separate dbias kernel alone."""
    q, k, v, out, lse, g = _case(2, 72, 72, 4, 64)
    before = _dbias_counts()
    A.flash_attention_backward(q, k, v, out, lse, g,
                               [torch.zeros(2, 1, 1, 72)], need_dq=False,
                               need_dkv=False, dbias_of=(0,))
    assert [c for c, _ in fake_card.calls] == [
        "flash_attention_bwd_delta", "flash_attention_bwd_dbias"]
    after = _dbias_counts()
    assert [x - y for x, y in zip(after, before)] == [0, 0, 1, 1, 0, 0]


@pytest.mark.parametrize("dbias_of", [(2,), (0, 0), (-1,)])
def test_dbias_of_names_distinct_biases(fake_card, dbias_of):
    q, k, v, out, lse, g = _case(2, 72, 72, 4, 64)
    with pytest.raises(ValueError, match="dbias_of"):
        A.flash_attention_backward(q, k, v, out, lse, g,
                                   [torch.zeros(1, 4, 72, 72)] * 2,
                                   dbias_of=dbias_of)
    assert fake_card.calls == []


class _Ctx:
    """Stands in for autograd's context of ``_FlashAttention``."""

    def __init__(self, saved, needs):
        self.saved_tensors, self.needs_input_grad = saved, needs
        self.scale, self.causal = 0.125, False


@pytest.mark.parametrize("needs_qkv", [(True, True, True),
                                       (True, False, False),
                                       (False, False, False)])
def test_the_autograd_backward_is_one_call(monkeypatch, needs_qkv):
    """``_FlashAttention.backward`` off the CPU makes one backward call for
    q, k, v and every bias that needs a gradient (the other biases get
    None); on the CPU one call of the plain version, likewise."""
    calls = []

    def spy(*args, **kw):
        calls.append(kw)
        q, k = args[0], args[1]
        return (torch.empty_like(q), torch.empty_like(k),
                torch.empty_like(k), *(torch.empty_like(args[6][i])
                                       for i in kw["dbias_of"]))

    monkeypatch.setattr(A, "flash_attention_backward", spy)
    q = torch.empty(2, 72, 4, 64, device="meta")
    k = torch.empty(2, 72, 4, 64, device="meta")
    lse = torch.empty(2, 4, 72, device="meta")
    rel = torch.empty(1, 4, 72, 72, device="meta")
    pad = torch.empty(2, 1, 1, 72, device="meta")
    ctx = _Ctx((q, k, k, q, lse, rel, pad),
               (*needs_qkv, False, False, True, False))
    grads = A._FlashAttention.backward(ctx, q)
    assert len(calls) == 1
    assert calls[0]["dbias_of"] == [0]
    assert (calls[0]["need_dq"], calls[0]["need_dkv"]) == (
        needs_qkv[0], needs_qkv[1] or needs_qkv[2])
    assert [x is None for x in grads] == [
        not needs_qkv[0], not needs_qkv[1], not needs_qkv[2], True, True,
        False, True]

    ref_calls = []
    ref = A.flash_attention_backward_ref

    def ref_spy(*args, **kw):
        ref_calls.append(kw)
        return ref(*args, **kw)

    monkeypatch.setattr(A, "flash_attention_backward_ref", ref_spy)
    gen = torch.Generator().manual_seed(0)
    qc, kc, vc = (torch.randn(1, 5, 2, 8, generator=gen).requires_grad_(
        need) for need in needs_qkv)
    relc = torch.randn(1, 2, 5, 5, generator=gen, requires_grad=True)
    padc = torch.zeros(1, 1, 1, 5)
    out = A.attention_core(qc, kc, vc, [relc, padc], 0.5)
    torch.autograd.grad(out, [t for t in (qc, kc, vc, relc)
                              if t.requires_grad], torch.ones_like(out))
    assert ref_calls == [{"dbias_of": [0]}]
