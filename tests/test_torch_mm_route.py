"""The tiled matmuls' dispatch (``ops/masked_linear.plan``, ``plan_wgmma``
and ``_launch``) on the CPU: which main loop a launch takes — the decode
kernel at decode-sized M, the Hopper TMA + wgmma loop above it (split-K
across a cluster where the output tiles do not fill the card), the WMMA
loop with its split-K only for what TMA cannot take, or the float32 one
— from the shape and the alignment alone, that K is covered exactly once
on the splits' 256-row boundaries, and that the wrappers count each
launch by loop (``tests/test_torch_decode_route.py`` holds the decode
kernel's own routing cases and the int8 wrapper's).  The kernels
themselves run only on the card (``tests/test_torch_cuda_kernels.py``)."""

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
    # output tiles that do not fill the card: the Hopper loop, split-K
    ("vit_proj_prefill", 1028, 1408, 1408, True, True, 0, ML.WGMMA),
    ("t5_dec_wi_train_r8", 384, 5120, 2048, True, True, 8, ML.WGMMA),
    ("qformer_self_gen_12_tiles", 288, 768, 768, True, True, 0, ML.WGMMA),
    ("m_65_past_decode", 65, 2048, 2048, True, True, 0, ML.WGMMA),
    # an adapter at decode-sized M: the decode kernel takes none
    ("adapter_at_m_20", 20, 2048, 2048, True, True, 8, ML.WMMA),
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
    elif loop == ML.WGMMA:
        assert (splits, k_split) == ML.plan_wgmma(m, n, k, SMS)
        assert splits == 1 or k_split % ML.WGMMA_K_UNIT == 0
    elif loop == ML.FP32:
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
    """Every bf16 main-path shape above decode-sized M goes to the Hopper
    loop — unsplit where the output tiles fill the card, split-K across a
    cluster where they do not, so no main-path shape runs the WMMA loop;
    decode shapes never do: they run the decode kernel, K split as
    ``plan_decode`` says."""
    loop, splits, k_split = ML.plan(m, n, k, SMS, rank=rank)
    tiles = -(-m // ML.WGMMA_BM) * -(-n // ML.WGMMA_BN)
    if case.endswith("_decode"):
        assert loop == ML.DECODE
        assert (splits, k_split) == ML.plan_decode(m, n, k, SMS)[1:]
    else:
        assert loop == ML.WGMMA
        assert (splits, k_split) == ML.plan_wgmma(m, n, k, SMS)
        assert (splits == 1) >= (tiles >= SMS)   # a full card is never split
        assert tiles * splits <= ML.wgmma_wave(SMS) or splits == 1


# K lengths of the main path and ragged ones (inside a 256-row unit, a
# step, a pack group), at tile counts from 1 to past the card
SPLIT_SHAPES = [(m, n, k) for m in (65, 128, 288, 384, 1028, 2304)
                for n in (768, 1296, 2048, 5120)
                for k in (768, 1000, 1408, 2048, 2056, 5120, 6144)]


@pytest.mark.parametrize("m,n,k", SPLIT_SHAPES,
                         ids=[f"{m}x{n}x{k}" for m, n, k in SPLIT_SHAPES])
def test_wgmma_splits_cover_k_once_on_group_boundaries(m, n, k):
    """Each split non-empty, all of K covered once; split boundaries on
    multiples of 256 (BK = 64 steps, both pack groups); at most a portable
    cluster; the same plan for every weight form and mask kind (the int8
    flag only steers the decode kernel), so the bit-equalities hold."""
    splits, k_split = ML.plan_wgmma(m, n, k, SMS)
    assert 1 <= splits <= ML.WGMMA_MAX_SPLITS
    assert (splits - 1) * k_split < k <= splits * k_split
    if splits > 1:
        assert k_split % ML.WGMMA_K_UNIT == 0
        assert k_split % 64 == 0 and k_split % 128 == 0
        # only tiles under a wave split, and never past one split a unit
        assert -(-m // 256) * -(-n // 128) * splits <= ML.wgmma_wave(SMS)
        assert splits <= -(-k // ML.WGMMA_K_UNIT)
    else:
        assert k_split == k
    for rank in (0, 2, 4, 8):
        for int8 in (False, True) if rank == 0 else (False,):
            assert ML.plan(m, n, k, SMS, rank=rank, int8=int8) == (
                ML.WGMMA, splits, k_split)


def test_wgmma_splits_fill_one_wave_of_clusters():
    """The most splits whose blocks fit one wave (110 at 132 SMs): ViT
    proj and fc2 prefill (55 tiles) two; T5 qkvo and wo prefill (32
    tiles) three; T5 wi prefill (80 tiles) and cross k/v (96) none; a
    seven-tile shape as many as its nine K units allow in 2-unit splits;
    ViT fc1 prefill (240 tiles) none."""
    assert ML.wgmma_wave(SMS) == 110
    for (m, n, k), want in [((1028, 1408, 1408), 2), ((1028, 1408, 6144), 2),
                            ((288, 2048, 2048), 3), ((288, 2048, 5120), 3),
                            ((288, 5120, 2048), 1), ((1440, 2048, 2048), 1),
                            ((100, 784, 2056), 5), ((1028, 6144, 1408), 1),
                            ((288, 768, 768), 3)]:
        splits, k_split = ML.plan_wgmma(m, n, k, SMS)
        assert splits == want, (m, n, k)
        tiles = -(-m // 256) * -(-n // 128)
        assert tiles * splits <= ML.wgmma_wave(SMS) or splits == 1


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
                                           (16, ML.DECODE, None),
                                           (288, ML.WGMMA, None)])
def test_wrappers_launch_the_planned_loop_and_count_it(fake_card, kind, m,
                                                       loop, forced):
    """At M = 16 the bool and packed matmuls run the decode kernel; the
    sparse-LoRA one, which it does not take, the WMMA loop.  At M = 288
    the 32 output tiles do not fill the card: the Hopper loop, split."""
    if kind == "lora" and loop == ML.DECODE:
        loop = ML.WMMA
    k, n = 1024, 2048
    x, w = _bf16(m, k), _bf16(k, n)
    mask = torch.ones(k, n, dtype=torch.bool)
    before = (ML.launches, ML.packed_launches, ML.lora_launches,
              ML.wgmma_launches, ML.decode_launches, ML.wmma_launches)
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
        # the Hopper entry points take the float32 ones' arguments and
        # the split plan, no workspace; the WMMA one its splits and vec flag
        if loop == ML.WGMMA:
            assert args[-6:-3] == (m, n, k)
            assert args[-3:-1] == ML.plan_wgmma(m, n, k, SMS)
        else:
            assert args[-7:-4] == (m, n, k)
    after = (ML.launches, ML.packed_launches, ML.lora_launches,
             ML.wgmma_launches, ML.decode_launches, ML.wmma_launches)
    which = ("bool", "packed", "lora").index(kind)
    assert after[which] == before[which] + 1
    assert after[3] == before[3] + (loop == ML.WGMMA)
    assert after[4] == before[4] + (loop == ML.DECODE)
    assert after[5] == before[5] + (loop == ML.WMMA)


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
    assert ML.wmma_calls[(2048, n, k, 4, "a base not 16-byte aligned")] >= 1


def test_only_the_wmma_loop_can_be_forced(fake_card):
    x, w = _bf16(2048, 64), _bf16(64, 2048)
    mask = torch.ones(64, 2048, dtype=torch.bool)
    with pytest.raises(ValueError, match="can be forced"):
        ML._masked_matmul_cuda(x, w, mask, ML.WGMMA)
    assert fake_card.calls == []


@pytest.mark.parametrize("name,m,k,n,r", CS.LORA_SHAPES,
                         ids=[c[0] for c in CS.LORA_SHAPES])
def test_every_training_shape_runs_the_hopper_loop(fake_card, name, m, k, n,
                                                   r):
    """The retrain step's sparse-LoRA launches, the Q-Former's and the T5
    decoder's under-filled ones included: the Hopper entry point with
    ``plan_wgmma``'s splits, no WMMA launch."""
    x, w = _bf16(m, k), _bf16(k, n)
    mask = torch.ones(k, n, dtype=torch.bool)
    before = ML.wmma_launches
    ML._sparse_lora_cuda(x, w, mask, _bf16(k, r), _bf16(r, n), 16.0 / r)
    (called, args), = fake_card.calls
    assert called == "sparse_lora_matmul_wgmma"
    assert args[5] == r and args[-6:-3] == (m, n, k)
    assert args[-3:-1] == ML.plan_wgmma(m, n, k, SMS)
    assert ML.wmma_launches == before


@pytest.mark.parametrize("m,n,k,rank,aligned,why", [
    (2048, 2048, 2048, 0, False, "a base not 16-byte aligned"),
    (2048, 2048, 1001, 0, True, "K % 8 != 0"),
    (2048, 1400, 2048, 0, True, "N % 16 != 0"),
    (2048, 2048, 2048, 3, True, "adapter rank 3"),
    (2048, 2048, 2048, 16, True, "adapter rank 16"),
    (20, 2048, 2048, 8, True, "an adapter at M <= 64"),
])
def test_wmma_launches_are_recorded_with_why(m, n, k, rank, aligned, why):
    """What still runs the WMMA loop, and the reason chip_smoke prints."""
    assert ML.plan(m, n, k, SMS, aligned=aligned, rank=rank)[0] == ML.WMMA
    assert ML.wmma_reason(m, n, k, aligned, rank) == why


def test_a_forced_launch_is_recorded_as_forced(fake_card):
    x, w = _bf16(2048, 64), _bf16(64, 2048)
    mask = torch.ones(64, 2048, dtype=torch.bool)
    before = ML.wmma_calls.get((2048, 2048, 64, 0, "forced"), 0)
    ML._masked_matmul_cuda(x, w, mask, ML.WMMA)
    assert ML.wmma_calls[(2048, 2048, 64, 0, "forced")] == before + 1


VQA_SHAPES = [c for c in CS.MM_SHAPES
              if c[0].endswith(("_beam_step", "_rank"))]


@pytest.mark.parametrize("name,m,k,n", VQA_SHAPES,
                         ids=[c[0] for c in VQA_SHAPES])
def test_launches_are_tallied_by_shape_and_loop(fake_card, name, m, k, n):
    """The VQA eval's beam-decode steps (M = 320) and ranking decoder: the
    bool matmul counts its launch under (M, N, K, plan's loop), which
    chip_smoke.py reads with ``read_shapes`` and clears with
    ``reset_counts``."""
    x, w = _bf16(m, k), _bf16(k, n)
    mask = torch.ones(k, n, dtype=torch.bool)
    CS.reset_counts()
    ML._masked_matmul_cuda(x, w, mask)
    ML._masked_matmul_cuda(x, w, mask)
    loop = ML.plan(m, n, k, SMS)[0]
    assert loop == ML.WGMMA
    assert CS.read_shapes()["matmul"] == {(m, n, k, loop): 2}
    CS.reset_counts()
    assert CS.read_shapes() == {"matmul": {}, "lora": {}, "attention": {},
                                "attention_bwd": {}}


@pytest.mark.parametrize("name,m,k,n,r", CS.LORA_SHAPES,
                         ids=[c[0] for c in CS.LORA_SHAPES])
def test_sparse_lora_launches_are_tallied_by_shape_and_rank(fake_card, name,
                                                            m, k, n, r):
    """The retrain's sparse-LoRA launches count under (M, N, K, loop) with
    the other matmuls and under (M, N, K, rank) on their own, which
    ``check_shapes`` holds to LORA_SHAPES."""
    x, w = _bf16(m, k), _bf16(k, n)
    mask = torch.ones(k, n, dtype=torch.bool)
    CS.reset_counts()
    ML._sparse_lora_cuda(x, w, mask, _bf16(k, r), _bf16(r, n), 16.0 / r)
    shapes = CS.read_shapes()
    assert shapes["matmul"] == {(m, n, k, ML.WGMMA): 1}
    assert shapes["lora"] == {(m, n, k, r): 1}
    CS.check_shapes({"retrain": shapes}, "retrain")
    CS.reset_counts()


def _retrain_tally():
    """A tally of every retrain shape phase 3 holds: each sparse-LoRA
    shape, each backward shape and the forward it starts from."""
    bwd = {(b, n, m, h, d, "wgmma"): 1
           for _, b, n, m, h, d, _, _ in CS.bwd_held()}
    return {"matmul": {(m, n, k, ML.WGMMA): 1
                       for _, m, k, n, _ in CS.LORA_SHAPES},
            "lora": {(m, n, k, r): 1 for _, m, k, n, r in CS.LORA_SHAPES},
            "attention": dict(bwd), "attention_bwd": dict(bwd)}


@pytest.mark.parametrize("kind,key", [
    ("lora", (2304, 4096, 4096, 4)),                  # a rank not held
    ("matmul", (2304, 4096, 4096, ML.WGMMA)),         # a masked launch
    ("attention", (32, 64, 64, 12, 64, "wgmma")),
    ("attention_bwd", (32, 64, 64, 12, 64, "wgmma")),
    ("attention_bwd", (8, 72, 72, 32, 128, "mma")),
])
def test_check_shapes_refuses_a_launch_phase_3_never_held(kind, key):
    CS.check_shapes({"retrain": _retrain_tally()}, "retrain")
    tally = _retrain_tally()
    tally[kind][key] = tally[kind].get(key, 0) + 1
    with pytest.raises(AssertionError, match="never held"):
        CS.check_shapes({"retrain": tally}, "retrain")
