"""The decode kernel's dispatch on the CPU (``ops/masked_linear.plan``,
``plan_decode`` and the bool, packed and int8 wrappers): every weight form
and mask kind of a decode-sized shape takes the one decode kernel with the
same K splits, the splits cover K once on 256-row boundaries and fill the
card about once, the threshold, misaligned and float32 cases keep their
loops, and the wrappers count the launches and honour ``_loop``; above
the threshold every form of a prefill shape takes the Hopper loop with
the same splits (the int8 one with its scale pointer), and the int8
codes' conversion to bf16 is exact.  The kernels themselves run only on
the card (``tests/test_torch_cuda_kernels.py``)."""

import numpy as np
import pytest
import torch

import chip_smoke as CS
from vlm_compression_tpu_torch.ops import bitmask as BM
from vlm_compression_tpu_torch.ops import masked_linear as ML
from vlm_compression_tpu_torch.ops import quant as Q

SMS = 132   # H100 SXM

# (M, K, N) of the main path's decode steps (4 requests × 5 beams)
DECODE_SHAPES = [(name, m, k, n) for name, m, k, n in CS.SERVE_SHAPES
                 if name.endswith("_decode")] + [
    (name, m, k, n) for name, m, k, n in CS.INT8_UNMASKED_SHAPES
    if name.endswith("_decode")]

FORMS = ["bool", "packed128", "packed256", "int8_none", "int8_bool",
         "int8_packed128", "int8_packed256"]


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
    monkeypatch.setattr(ML._cuda, "stream_ptr", lambda dev: 0)
    monkeypatch.setattr(ML._cuda, "sm_count", lambda dev: SMS)
    monkeypatch.setattr(ML._cuda, "library", lambda name: lib)
    monkeypatch.setattr(ML, "_valid", lambda *a, **k: True)
    monkeypatch.setattr(Q, "_valid_int8", lambda *a, **k: True)
    return lib


def _counts():
    return {"bool": ML.launches, "packed": ML.packed_launches,
            "int8": Q.int8_launches, "decode": ML.decode_launches,
            "wgmma": ML.wgmma_launches, "wmma": ML.wmma_launches}


def _run(form, m, k, n, loop=None, x=None):
    """One call of ``form``'s card wrapper on zero operands (the public
    wrappers would take the plain version for CPU tensors); returns the
    counter that form bumps and the (w_int8, mask_kind, group) the decode
    entry point must receive."""
    x = torch.zeros(m, k, dtype=torch.bfloat16) if x is None else x
    mask = torch.ones(k, n, dtype=torch.bool)
    kind, _, mk = form.partition("_")
    if form.startswith("int8"):
        q, scale = torch.zeros(k, n, dtype=torch.int8), torch.ones(n)
        arg = {"none": None, "bool": mask}.get(mk)
        if mk.startswith("packed"):
            arg = BM.pack_mask(mask, int(mk[6:]))
        Q._int8_matmul_cuda(x, q, scale, arg, loop)
        group = int(mk[6:]) if mk.startswith("packed") else 0
        return "int8", (1, ("none", "bool").index(mk)
                        if not group else 2, group)
    w = torch.zeros(k, n, dtype=torch.bfloat16)
    if form == "bool":
        ML._masked_matmul_cuda(x, w, mask, loop)
        return "bool", (0, 1, 0)
    group = int(form[6:])
    ML._masked_matmul_packed_cuda(x, w, BM.pack_mask(mask, group), loop)
    return "packed", (0, 2, group)


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name,m,k,n", DECODE_SHAPES,
                         ids=[s[0] for s in DECODE_SHAPES])
def test_every_form_of_a_decode_shape_takes_the_decode_kernel(
        fake_card, form, name, m, k, n):
    """Bool, packed (G 128, 256) and int8 with every mask kind: one entry
    point, one split plan, so the bit-equalities between the forms hold."""
    before = _counts()
    counter, (w_int8, mask_kind, group) = _run(form, m, k, n)
    (called, args), = fake_card.calls
    assert called == "matmul_decode"
    # x, w, w_int8, mask, mask_kind, group, scale, y, m, n, k, splits,
    # k_split, stream
    assert (args[2], args[4], args[5]) == (w_int8, mask_kind, group)
    assert (args[3] is None) == (mask_kind == 0)
    assert (args[6] is None) == (not w_int8)
    assert args[8:11] == (m, n, k)
    assert args[11:13] == ML.plan_decode(m, n, k, SMS, bool(w_int8))[1:]
    after = _counts()
    assert after[counter] == before[counter] + 1
    assert after["decode"] == before["decode"] + 1
    assert after["wgmma"] == before["wgmma"]
    assert after["wmma"] == before["wmma"]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("m,n,k", [
    (20, 2048, 2048), (20, 5120, 2048), (20, 2048, 5120),
    (20, 32128, 2048), (1, 64, 8), (64, 16, 256), (20, 2064, 2056),
    (7, 5120, 1000), (33, 784, 4104), (20, 2048, 65536), (20, 16, 5120)])
def test_plan_decode_covers_k_once_on_unit_boundaries(m, n, k, int8):
    bn, splits, k_split = ML.plan_decode(m, n, k, SMS, int8)
    assert bn == ML.DECODE_BN
    assert 1 <= splits <= ML.DECODE_MAX_SPLITS
    assert k_split % ML.DECODE_K_UNIT == 0
    assert k_split % 256 == 0 and k_split % 128 == 0   # both pack groups
    # every split non-empty, all of K covered once
    assert (splits - 1) * k_split < k <= splits * k_split
    # as many blocks as SMs (int8) or half as many (bf16) where K allows
    tiles = -(-n // bn)
    target = SMS if int8 else SMS // 2
    assert tiles * splits >= min(target, tiles * ML.DECODE_MAX_SPLITS,
                                 tiles * -(-k // ML.DECODE_K_UNIT)) * 0.75


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("name,m,k,n", DECODE_SHAPES,
                         ids=[s[0] for s in DECODE_SHAPES])
def test_main_path_decode_shapes_fill_the_card_about_once(name, m, k, n,
                                                          int8):
    """At the T5 decode shapes, about one block an SM for int8 codes and
    half that for bf16 weights, no more splits than that needs; the LM
    head's 502 column tiles need no split."""
    _, splits, k_split = ML.plan_decode(m, n, k, SMS, int8)
    tiles = -(-n // ML.DECODE_BN)
    target = SMS if int8 else SMS // 2
    if tiles >= target:
        assert splits == 1 and k_split >= k
    else:
        assert target * 0.9 <= tiles * splits < target + tiles


@pytest.mark.parametrize("m,n,k,bf16,aligned,rank,loop", [
    (1, 2048, 2048, True, True, 0, ML.DECODE),
    (64, 2048, 2048, True, True, 0, ML.DECODE),    # the threshold
    (65, 2048, 2048, True, True, 0, ML.WGMMA),     # past it: split-K
    (20, 2048, 2048, True, False, 0, ML.WMMA),     # misaligned base
    (20, 2040, 2048, True, True, 0, ML.WMMA),      # N % 16 != 0
    (20, 2048, 2044, True, True, 0, ML.WMMA),      # K % 8 != 0
    (20, 2048, 2048, False, True, 0, ML.FP32),     # float32
    (20, 2048, 2048, True, True, 8, ML.WMMA),      # an adapter
    (20, 32128, 2048, True, True, 0, ML.DECODE),   # LM head: not WGMMA
    (288, 2048, 2048, True, True, 0, ML.WGMMA),    # prefill: Hopper
])
def test_threshold_alignment_and_dtype_keep_their_loops(m, n, k, bf16,
                                                        aligned, rank, loop):
    assert ML.plan(m, n, k, SMS, bf16=bf16, aligned=aligned,
                   rank=rank)[0] == loop


@pytest.mark.parametrize("m", [1, 7, 20, 33, 64])
def test_every_decode_sized_m_takes_the_decode_kernel(fake_card, m):
    before = ML.decode_launches
    _run("packed128", m, 2048, 5120)
    (called, args), = fake_card.calls
    assert called == "matmul_decode" and args[8] == m
    assert ML.decode_launches == before + 1


@pytest.mark.parametrize("form", ["bool", "packed128", "int8_none",
                                  "int8_packed128"])
def test_forced_wmma_loop_is_honoured_and_counted(fake_card, form):
    """``_loop=WMMA`` (the timing phase's yardstick) runs the WMMA loop at
    a decode shape, counted as a WMMA launch."""
    before = _counts()
    counter, _ = _run(form, 20, 2048, 5120, loop=ML.WMMA)
    (called, args), = fake_card.calls
    assert called.endswith("_bf16")
    assert called.startswith("int8" if form.startswith("int8")
                             else "masked_matmul")
    after = _counts()
    assert after[counter] == before[counter] + 1
    assert after["decode"] == before["decode"]
    assert after["wmma"] == before["wmma"] + 1


@pytest.mark.parametrize("form", ["bool", "int8_bool"])
def test_only_the_wmma_loop_can_be_forced(fake_card, form):
    with pytest.raises(ValueError, match="can be forced"):
        _run(form, 20, 2048, 5120, loop=ML.DECODE)
    assert fake_card.calls == []


@pytest.mark.parametrize("form", ["int8_none", "int8_bool",
                                  "int8_packed128"])
def test_int8_prefill_stays_on_the_wmma_loop(fake_card, form):
    """Above the decode threshold int8 takes the bf16 forms' loop, the
    Hopper one, for every mask kind: its own entry point, with the same
    split plan."""
    before = _counts()
    _run(form, 1028, 1408, 6144)
    (called, args), = fake_card.calls
    assert called == "int8_matmul_wgmma"
    assert args[-6:-3] == (1028, 6144, 1408)
    assert args[-3:-1] == ML.plan_wgmma(1028, 6144, 1408, SMS) == (1, 1408)
    assert ML.plan(1028, 6144, 1408, SMS)[0] == ML.WGMMA
    after = _counts()
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["wmma"] == before["wmma"]


PREFILL_SHAPES = [(name, m, k, n) for name, m, k, n in CS.SERVE_SHAPES
                  if not name.endswith("_decode")] + [
    (name, m, k, n) for name, m, k, n in CS.INT8_UNMASKED_SHAPES
    if not name.endswith("_decode")]
PREFILL_FORMS = FORMS + ["int8_packed256"]


@pytest.mark.parametrize("form", PREFILL_FORMS)
@pytest.mark.parametrize("name,m,k,n", PREFILL_SHAPES,
                         ids=[s[0] for s in PREFILL_SHAPES])
def test_every_form_of_a_prefill_shape_takes_the_hopper_loop(
        fake_card, form, name, m, k, n):
    """Every prefill launch of the serving path, in every weight form and
    mask kind: the form's Hopper entry point with ``plan_wgmma``'s splits
    (split-K where the output tiles do not fill the card), so no prefill
    shape runs the WMMA loop and the forms stay bit-equal; int8 passes its
    mask kind, group and scale pointer."""
    before = _counts()
    if form.startswith("int8"):
        x = torch.zeros(m, k, dtype=torch.bfloat16)
        q, scale = torch.zeros(k, n, dtype=torch.int8), torch.ones(n)
        kind = form[5:]
        mask = torch.ones(k, n, dtype=torch.bool)
        mk = {"none": None, "bool": mask}.get(kind)
        group = int(kind[6:]) if kind.startswith("packed") else 0
        if group:
            mk = BM.pack_mask(mask, group)
        Q._int8_matmul_cuda(x, q, scale, mk)
        (called, args), = fake_card.calls
        assert called == "int8_matmul_wgmma"
        # x, q, mask, mask_kind, group, scale, y, m, n, k, splits, k_split,
        # stream
        assert (args[3], args[4]) == (("none", "bool").index(kind)
                                      if not group else 2, group)
        assert (args[2] is None) == (kind == "none")
        assert args[5] == scale.data_ptr()
        counter = "int8"
    else:
        counter, _ = _run(form, m, k, n)
        (called, args), = fake_card.calls
        assert called == ("masked_matmul_wgmma" if form == "bool"
                          else "masked_matmul_packed_wgmma")
    assert args[-6:-3] == (m, n, k)
    assert args[-3:-1] == ML.plan_wgmma(m, n, k, SMS)
    after = _counts()
    assert after[counter] == before[counter] + 1
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["decode"] == before["decode"]
    assert after["wmma"] == before["wmma"]


def _code_to_bf16(codes: np.ndarray) -> np.ndarray:
    """The kernels' conversion of int8 codes, emulated: byte q + 128 (the
    code xor 0x80) under the exponent of 2^23 (``__byte_perm`` with
    0x4B000000) is the float 2^23 + q + 128; less 2^23 + 128 in fp32; then
    the bf16 pair's rounding (round to nearest even), as bf16 bits."""
    quad = codes.view(np.uint8).astype(np.uint32) ^ np.uint32(0x80)
    f = np.array([_byte_perm(int(b), 0x4B000000, 0x7540) for b in quad],
                 dtype=np.uint32).view(np.float32)
    v = (f - np.float32(8388736.0)).astype(np.float32)
    bits = v.view(np.uint32)
    rounded = bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16))
                                          & np.uint32(1))
    return (rounded >> np.uint32(16)).astype(np.uint16)


def test_code_conversion_is_exact_for_every_code():
    """All 255 codes (and -128) become their bf16 value exactly; a masked
    byte and a zero code both become +0."""
    codes = np.arange(-128, 128, dtype=np.int8)
    got = _code_to_bf16(codes)
    want = (torch.from_numpy(codes.astype(np.float32)).to(torch.bfloat16)
            .view(torch.int16).numpy().view(np.uint16))
    np.testing.assert_array_equal(got, want)
    assert _code_to_bf16(np.zeros(1, np.int8))[0] == 0   # +0, not -0


def _byte_perm(x: int, y: int, sel: int) -> int:
    """CUDA's ``__byte_perm``: byte n of the result is byte (sel >> 4n) & 7
    of the eight bytes of y:x."""
    src = (y << 32) | x
    return sum(((src >> (8 * ((sel >> (4 * n)) & 7))) & 0xFF) << (8 * n)
               for n in range(4))


def _keep_bytes(words: np.ndarray, k0: int, q: int, group: int) -> np.ndarray:
    """The int8 transform's packed-mask gather (``convert_codes`` in
    csrc/wgmma_tile.cuh), emulated for thread row q of a K step at k0 over
    all 16 chunks of 8 columns: the chunk's 8 words of word row
    8·(k0 / G) + q, each shifted by the step's bit, their low bytes
    gathered by ``__byte_perm`` into kl (columns 0-3) and kh (4-7); row i
    keeps byte e of ((kl or kh) >> i) & 0x01010101.  Returns keep[i,
    column] for i < 8."""
    bit = ((k0 + q) % group) >> 3
    row = words[8 * (k0 // group) + q]
    keep = np.zeros((8, words.shape[1]), dtype=bool)
    for c in range(words.shape[1] // 8):
        w = [int(v) >> bit for v in row[8 * c:8 * c + 8]]
        kl = _byte_perm(_byte_perm(w[0], w[1], 0x0040),
                        _byte_perm(w[2], w[3], 0x0040), 0x5410)
        kh = _byte_perm(_byte_perm(w[4], w[5], 0x0040),
                        _byte_perm(w[6], w[7], 0x0040), 0x5410)
        for i in range(8):
            quads = ((kl >> i) & 0x01010101, (kh >> i) & 0x01010101)
            for e in range(8):
                keep[i, 8 * c + e] = (quads[e // 4] >> (8 * (e % 4))) & 1
    return keep


@pytest.mark.parametrize("group", [128, 256])
def test_packed_bits_gather_matches_the_unpacked_mask(group):
    """For every K step of 64 rows and every thread row q, the gathered
    keep bits equal the bool mask rows q + 8i: the kernel's byte masks
    zero exactly the codes off the mask."""
    rng = np.random.default_rng(3)
    k, n = 2 * group + 64, 128
    mask = torch.from_numpy(rng.random((k, n)) < 0.5)
    words = BM.pack_mask(mask, group).numpy().view(np.uint32)
    for k0 in range(0, k, 64):
        for q in range(8):
            rows = [k0 + q + 8 * i for i in range(8)]
            np.testing.assert_array_equal(_keep_bytes(words, k0, q, group),
                                          mask.numpy()[rows])


@pytest.mark.parametrize("form", ["bool", "int8_packed128"])
def test_a_misaligned_x_at_a_decode_shape_takes_the_wmma_loop(fake_card,
                                                              form):
    x = torch.zeros(20 * 2048 + 1, dtype=torch.bfloat16)[1:].view(20, 2048)
    assert x.data_ptr() % 16 != 0
    before = _counts()
    _run(form, 20, 2048, 5120, x=x)
    (called, _), = fake_card.calls
    assert called.endswith("_bf16")
    after = _counts()
    assert after["decode"] == before["decode"]
    assert after["wmma"] == before["wmma"] + 1
