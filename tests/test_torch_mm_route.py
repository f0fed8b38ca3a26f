"""The tiled matmuls' dispatch (``ops/masked_linear.plan`` and ``_launch``)
on the CPU: which main loop a launch takes — the decode kernel at
decode-sized M, the Hopper TMA + wgmma loop, the WMMA loop with its
split-K, or the float32 one — from the shape and the alignment alone,
that K is covered exactly once, and that the wrappers count the Hopper
loop's and the decode kernel's launches (``tests/test_torch_decode_route.py``
holds the decode kernel's own routing cases).  The kernels themselves run only on the
card (``tests/test_torch_cuda_kernels.py``)."""

import pytest
import torch

import chip_smoke as CS
from vlm_compression_tpu_torch.ops import masked_linear as ML

SMS = 132   # H100 SXM

# (case, m, n, k, bf16, aligned, rank, loop)
CASES = [
    ("vit_fc1_calib", 32896, 6144, 1408, True, True, 0, ML.WGMMA),
    ("t5_wo_calib", 9216, 2048, 5120, True, True, 0, ML.WGMMA),
    ("t5_dec_qkvo_calib_96_tiles", 1536, 2048, 2048, True, True, 0, ML.WGMMA),
    ("vit_fc1_train_r4", 8224, 6144, 1408, True, True, 4, ML.WGMMA),
    ("t5_enc_wi_train_r8", 2304, 5120, 2048, True, True, 8, ML.WGMMA),
    ("qformer_ffn_train_r2", 1024, 3072, 768, True, True, 2, ML.WGMMA),
    ("vit_qkv_prefill", 1028, 4224, 1408, True, True, 0, ML.WGMMA),
    ("ragged_n_1392", 2000, 1392, 1408, True, True, 0, ML.WGMMA),
    ("ragged_mk", 1100, 2048, 1000, True, True, 0, ML.WGMMA),
    # decode-sized M: the decode kernel, K split across a cluster
    ("t5_wi_decode", 20, 5120, 2048, True, True, 0, ML.DECODE),
    ("t5_wo_decode", 20, 2048, 5120, True, True, 0, ML.DECODE),
    ("vit_proj_prefill", 1028, 1408, 1408, True, True, 0, ML.WMMA),
    ("t5_dec_wi_train_r8", 384, 5120, 2048, True, True, 8, ML.WMMA),
    # what TMA cannot take: N % 16, K % 8, a misaligned base
    ("n_1400_not_16", 2000, 1400, 1408, True, True, 0, ML.WMMA),
    ("k_1001_not_8", 2000, 2048, 1001, True, True, 0, ML.WMMA),
    ("misaligned_base", 32896, 6144, 1408, True, False, 0, ML.WMMA),
    # ranks the Hopper loop does not hold in registers
    ("rank_3", 8224, 6144, 1408, True, True, 3, ML.WMMA),
    ("rank_16", 8224, 6144, 1408, True, True, 16, ML.WMMA),
    # float32: the CUDA-core loop at every shape
    ("fp32_calib", 32896, 6144, 1408, False, True, 0, ML.FP32),
    ("fp32_decode", 20, 5120, 2048, False, True, 0, ML.FP32),
    ("fp32_lora", 8224, 6144, 1408, False, True, 4, ML.FP32),
]


@pytest.mark.parametrize("case,m,n,k,bf16,aligned,rank,loop", CASES,
                         ids=[c[0] for c in CASES])
def test_plan_picks_the_loop_and_covers_k_once(case, m, n, k, bf16, aligned,
                                              rank, loop):
    got, splits, k_split = ML.plan(m, n, k, SMS, bf16=bf16, aligned=aligned,
                                   rank=rank)
    assert got == loop
    assert splits >= 1 and (splits - 1) * k_split < k <= splits * k_split
    if loop == ML.DECODE:
        assert (splits, k_split) == ML.plan_decode(m, n, k, SMS)[1:]
        assert k_split % ML.DECODE_K_UNIT == 0
    elif loop != ML.WMMA:
        assert (splits, k_split) == (1, k)    # one launch over all of K
    else:
        assert (splits, k_split) == ML.split_k(m, n, k, SMS)
        assert k_split % 32 == 0


def _main_path_shapes():
    out = [(f"mm {name}", m, n, k, 0) for name, m, k, n in CS.MM_SHAPES]
    out += [(f"lora {name}", m, n, k, r)
            for name, m, k, n, r in CS.LORA_SHAPES]
    out += [(f"serve {name}", m, n, k, 0) for name, m, k, n in CS.SERVE_SHAPES]
    return out


@pytest.mark.parametrize("case,m,n,k,rank", _main_path_shapes(),
                         ids=[c[0] for c in _main_path_shapes()])
def test_main_path_runs_the_hopper_loop_wherever_k_is_not_split(case, m, n,
                                                                 k, rank):
    """Every bf16 main-path shape that the WMMA loop would run unsplit goes
    to the Hopper loop; decode shapes never do: they run the decode
    kernel, K split as ``plan_decode`` says."""
    loop, splits, k_split = ML.plan(m, n, k, SMS, rank=rank)
    wmma_splits, _ = ML.split_k(m, n, k, SMS)
    assert (loop == ML.WGMMA) == (wmma_splits == 1)
    if case.endswith("_decode"):
        assert loop == ML.DECODE
        assert (splits, k_split) == ML.plan_decode(m, n, k, SMS)[1:]


class _Lib:
    """Stands in for the kernel library: records each entry point's call."""

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
    monkeypatch.setattr(ML._cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(ML._cuda, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(ML._cuda, "library", lambda name: lib)
    monkeypatch.setattr(ML, "_valid", lambda *a, **k: True)
    return lib


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("kind", ["bool", "packed", "lora"])
@pytest.mark.parametrize("m,loop,forced", [(2048, ML.WGMMA, None),
                                           (2048, ML.WMMA, ML.WMMA),
                                           (16, ML.DECODE, None)])
def test_wrappers_launch_the_planned_loop_and_count_it(fake_card, kind, m,
                                                       loop, forced):
    """At M = 16 the bool and packed matmuls run the decode kernel; the
    sparse-LoRA one, which it does not take, the WMMA loop."""
    if kind == "lora" and loop == ML.DECODE:
        loop = ML.WMMA
    k, n = 1024, 2048
    x, w = _bf16(m, k), _bf16(k, n)
    mask = torch.ones(k, n, dtype=torch.bool)
    before = (ML.launches, ML.packed_launches, ML.lora_launches,
              ML.wgmma_launches, ML.decode_launches)
    if kind == "bool":
        ML._masked_matmul_cuda(x, w, mask, forced)
        name = "masked_matmul"
    elif kind == "packed":
        packed = torch.zeros(64, n, dtype=torch.int32)   # G = 128
        ML._masked_matmul_packed_cuda(x, w, packed, forced)
        name = "masked_matmul_packed"
    else:
        a, b = _bf16(k, 4), _bf16(4, n)
        ML._sparse_lora_cuda(x, w, mask, a, b, 4.0, forced)
        name = "sparse_lora_matmul"
    (called, args), = fake_card.calls
    if loop == ML.DECODE:
        # one entry point for every form: ..., m, n, k, splits, k_split
        assert called == "matmul_decode"
        assert args[-6:-3] == (m, n, k)
        assert args[-3:-1] == ML.plan_decode(m, n, k, SMS)[1:]
    else:
        assert called == \
            f"{name}_{'wgmma' if loop == ML.WGMMA else 'bf16'}"
        # the Hopper entry points take the float32 ones' arguments: no
        # workspace, no splits; the WMMA one its splits and vec flag
        assert args[-4:-1] == (m, n, k) if loop == ML.WGMMA \
            else args[-7:-4] == (m, n, k)
    after = (ML.launches, ML.packed_launches, ML.lora_launches,
             ML.wgmma_launches, ML.decode_launches)
    which = ("bool", "packed", "lora").index(kind)
    assert after[which] == before[which] + 1
    assert after[3] == before[3] + (loop == ML.WGMMA)
    assert after[4] == before[4] + (loop == ML.DECODE)


def test_a_misaligned_adapter_takes_the_wmma_loop(fake_card):
    """A or B off a 16-byte boundary: the bulk copy and the 16-byte B loads
    cannot take them, so the plan is the WMMA loop."""
    k, n = 64, 2048
    x, w = _bf16(2048, k), _bf16(k, n)
    mask = torch.ones(k, n, dtype=torch.bool)
    a = _bf16(k * 4 + 1, 1)[1:].view(k, 4)        # 2 bytes off
    assert a.data_ptr() % 16 != 0
    before = ML.wgmma_launches
    ML._sparse_lora_cuda(x, w, mask, a, _bf16(4, n), 4.0)
    (called, _), = fake_card.calls
    assert called == "sparse_lora_matmul_bf16"
    assert ML.wgmma_launches == before


def test_only_the_wmma_loop_can_be_forced(fake_card):
    x, w = _bf16(2048, 64), _bf16(64, 2048)
    mask = torch.ones(64, 2048, dtype=torch.bool)
    with pytest.raises(ValueError, match="can be forced"):
        ML._masked_matmul_cuda(x, w, mask, ML.WGMMA)
    assert fake_card.calls == []
