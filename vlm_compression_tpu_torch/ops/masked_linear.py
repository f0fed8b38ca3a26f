"""Masked and sparse-LoRA matmuls — the sparse forward paths.

Counterpart of ``vlm_compression_tpu/ops/masked_linear.py``.  Layout as
there: x (..., in), W (in, out), mask (in, out) bool, True = keep, or its
bit-packed words (``ops/bitmask.py``), A (in, r), B (r, out).

  masked         y = x · (W ⊙ M)
  masked_packed  y = x · (W ⊙ unpack(P))       (P: 1 or 2 bits a weight)
  sparse_lora    y = x · ((W + s·A·B) ⊙ M)      (mask over the sum)
  lora           y = x · (W ⊙ M) + (x·A)·B·s     (ablation: mask on the base)

``masked_matmul``, ``masked_matmul_packed`` and ``sparse_lora_matmul`` are
autograd Functions whose forward runs the plain version on CPU tensors and
a hand-written kernel of ``csrc/masked_matmul.cu`` on CUDA tensors (launch
or raise — no fallback), and whose backward is the JAX package's
hand-written VJP in plain matmuls (as there, the backward products are left
to the matmul library; the packed backward unpacks, as the JAX one does).
``plan`` picks each bf16 launch's main loop from the shape and alignment
alone: the decode kernel (``csrc/matmul_decode.cu``: swap-AB, W streamed
by TMA, split-K across a thread-block cluster) at decode-sized M, the
Hopper TMA + wgmma loop (``csrc/wgmma_tile.cuh``) above it — unsplit where
the output tiles fill the card, split-K across a cluster where they do
not — and the WMMA loop with split-K only for what TMA cannot take.
``launches``, ``packed_launches`` and ``lora_launches`` count kernel
launches; ``wgmma_launches``, ``decode_launches`` and ``wmma_launches``
those that ran the Hopper loop, the decode kernel and the WMMA loop (the
int8 kernel's too), ``wmma_calls`` the WMMA-loop launches by shape and
by why the other loops refused them, ``shape_launches`` every counted
launch by shape and loop, and ``lora_shape_launches`` the sparse-LoRA ones
by shape and rank.
"""

from __future__ import annotations

import torch

from vlm_compression_tpu_torch.ops import _cuda
from vlm_compression_tpu_torch.ops.bitmask import (
    infer_pack_group,
    is_packed,
    unpack_mask,
)

launches = 0
packed_launches = 0
lora_launches = 0
wgmma_launches = 0
decode_launches = 0
wmma_launches = 0
# (M, N, K, rank, why) -> WMMA-loop launches
wmma_calls: dict = {}
# (M, N, K, loop) -> launches
shape_launches: dict = {}
# (M, N, K, rank) -> sparse-LoRA launches
lora_shape_launches: dict = {}


def masked_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      mask: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain version: fp32 accumulation, cast to x's dtype (the JAX
    reference's dot_general with preferred_element_type=float32), or to
    ``out_dtype``."""
    wm = torch.where(mask, w, torch.zeros((), dtype=w.dtype, device=w.device))
    return torch.matmul(x.float(), wm.float()).to(out_dtype or x.dtype)


def masked_matmul_packed_ref(x: torch.Tensor, w: torch.Tensor,
                             packed: torch.Tensor) -> torch.Tensor:
    """Plain version: unpack (the group from the shapes), then
    ``masked_matmul_ref``."""
    k = w.shape[0]
    return masked_matmul_ref(x, w, unpack_mask(
        packed, k, infer_pack_group(k, packed.shape[0])))


def lora_delta(lora_a: torch.Tensor, lora_b: torch.Tensor,
               scale: float) -> torch.Tensor:
    """s·A·B in float32."""
    return scale * torch.matmul(lora_a.float(), lora_b.float())


def sparse_lora_weight(w, mask, lora_a, lora_b, scale) -> torch.Tensor:
    """E = (W + s·A·B) ⊙ M: the fp32 merge, masked, cast to W's dtype."""
    eff = w.float() + lora_delta(lora_a, lora_b, scale)
    return torch.where(mask, eff, torch.zeros((), device=w.device)).to(w.dtype)


def sparse_lora_matmul_ref(x, w, mask, lora_a, lora_b, scale,
                           out_dtype=None):
    """Plain version: the merged weight materialized, then x · E (cast to
    x's dtype, or to ``out_dtype``)."""
    return torch.matmul(x.float(), sparse_lora_weight(
        w, mask, lora_a, lora_b, scale).float()).to(out_dtype or x.dtype)


def lora_matmul_ref(x, w, mask, lora_a, lora_b, scale, out_dtype=None):
    """x · (W ⊙ M) + s·(x·A)·B, the adapter outside the mask (in x's dtype,
    or ``out_dtype``)."""
    base = masked_matmul_ref(x, w, mask, out_dtype)
    z = torch.matmul(torch.matmul(x.float(), lora_a.float()).to(x.dtype)
                     .float(), lora_b.float()).to(x.dtype)
    return base + (scale * z.float()).to(out_dtype or x.dtype)


def merge_sparse_lora(w, mask, lora_a, lora_b, scale, sparse: bool = True):
    """Merge adapters into the base weight:
    sparse=True   W + (s·A·B) ⊙ M       (stays sparse)
    sparse=False  W ⊙ M + s·A·B         (densifies — the ablation)."""
    delta = lora_delta(lora_a, lora_b, scale)
    w32 = w.float()
    zero = torch.zeros((), device=w.device)
    out = (w32 + torch.where(mask, delta, zero) if sparse
           else torch.where(mask, w32, zero) + delta)
    return out.to(w.dtype)


def _needs_graph(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _masked_grad(x, g, mask) -> torch.Tensor:
    """Gm = M ⊙ (xᵀ·g) over all leading dims: x's dtype in, fp32 sums and
    out (JAX's dot_general with preferred_element_type=float32).  The card
    multiplies bf16 in bf16 with an fp32 result; the CPU, whose matmul has
    no such variant, in fp32 — the same values, bf16 being exact in fp32."""
    x2 = x.reshape(-1, x.shape[-1]).t()
    g2 = g.reshape(-1, g.shape[-1])
    if x.is_cuda and x.dtype == torch.bfloat16 and g.dtype == x.dtype:
        gm = torch.mm(x2, g2, out_dtype=torch.float32)
    else:
        gm = torch.matmul(x2.float(), g2.float())
    return torch.where(mask, gm, torch.zeros((), device=gm.device))


def _masked_vjp(ctx, x, w, mask, g):
    """JAX ``_masked_matmul_bwd``: dx = g·(W⊙M)ᵀ, dW = M ⊙ (xᵀg).  A float32
    g of a bf16 product's fp32 output holds bf16 values (the output is
    rounded once after it): cast back, exactly."""
    g = g.to(x.dtype)
    dx = dw = None
    if ctx.needs_input_grad[0]:
        wm = torch.where(mask, w, torch.zeros((), dtype=w.dtype,
                                              device=w.device))
        dx = torch.matmul(g, wm.t()).to(x.dtype)
    if ctx.needs_input_grad[1]:
        dw = _masked_grad(x, g, mask).to(w.dtype)
    return dx, dw, None


class _MaskedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mask, loop, out32):
        ctx.save_for_backward(x, w, mask)
        return _masked_matmul_fwd(x, w, mask, loop, out32)

    @staticmethod
    def backward(ctx, g):
        return *_masked_vjp(ctx, *ctx.saved_tensors, g), None, None


class _MaskedMatmulPacked(torch.autograd.Function):
    """JAX ``_masked_matmul_packed_bwd``: unpack, then the masked VJP."""

    @staticmethod
    def forward(ctx, x, w, packed, loop):
        ctx.save_for_backward(x, w, packed)
        return _masked_matmul_packed_fwd(x, w, packed, loop)

    @staticmethod
    def backward(ctx, g):
        x, w, packed = ctx.saved_tensors
        k = w.shape[0]
        mask = unpack_mask(packed, k, infer_pack_group(k, packed.shape[0]))
        return *_masked_vjp(ctx, x, w, mask, g), None


class _SparseLoraMatmul(torch.autograd.Function):
    """JAX ``_sparse_lora_bwd``: with E = (W + s·A·B) ⊙ M, dx = g·Eᵀ,
    Gm = M ⊙ (xᵀg) in fp32, dW = Gm, dA = s·Gm·Bᵀ, dB = s·Aᵀ·Gm.  Only
    (x, W, M, A, B) are saved: E is rebuilt in the backward, so no per-layer
    merged weight stays alive between the passes."""

    @staticmethod
    def forward(ctx, x, w, mask, lora_a, lora_b, scale, loop, out32):
        ctx.save_for_backward(x, w, mask, lora_a, lora_b)
        ctx.scale = scale
        if x.device.type == "cpu":
            return sparse_lora_matmul_ref(
                x, w, mask, lora_a, lora_b, scale,
                torch.float32 if out32 else None)
        return _sparse_lora_cuda(x, w, mask, lora_a, lora_b, scale, loop,
                                 out32=out32)

    @staticmethod
    def backward(ctx, g):
        x, w, mask, lora_a, lora_b = ctx.saved_tensors
        g = g.to(x.dtype)      # as _masked_vjp's
        s = ctx.scale
        need_x, need_w, _, need_a, need_b, _, _, _ = ctx.needs_input_grad
        dx = dw = da = db = None
        if need_x:
            e = sparse_lora_weight(w, mask, lora_a, lora_b, s)
            dx = torch.matmul(g, e.t()).to(x.dtype)
            del e
        if need_w or need_a or need_b:
            gm = _masked_grad(x, g, mask)
            if need_w:
                dw = gm.to(w.dtype)
            if need_a:
                da = (s * torch.matmul(gm, lora_b.float().t())
                      ).to(lora_a.dtype)
            if need_b:
                db = (s * torch.matmul(lora_a.float().t(), gm)
                      ).to(lora_b.dtype)
        return dx, dw, None, da, db, None, None, None


# ``_loop`` (all three wrappers): None runs the loop ``plan`` picks; WMMA
# forces the WMMA loop where the plan is another — for timing the loops
# side by side on the card, not a knob of the model.

def masked_matmul(x: torch.Tensor, w: torch.Tensor,
                  mask: torch.Tensor, *, out_dtype=None,
                  _loop=None) -> torch.Tensor:
    """y = x @ (w ⊙ mask); the masked weight never exists in memory on the
    card.  Differentiable in x and w.  ``out_dtype`` float32 with bf16
    operands: the fp32 sums, unrounded (a row-parallel shard's partials,
    rounded once after the sum over ranks)."""
    out32 = _out32(x, out_dtype)
    if _needs_graph(x, w):
        return _MaskedMatmul.apply(x, w, mask, _loop, out32)
    return _masked_matmul_fwd(x, w, mask, _loop, out32)


def masked_matmul_packed(x: torch.Tensor, w: torch.Tensor,
                         packed: torch.Tensor, *, _loop=None) -> torch.Tensor:
    """y = x @ (w ⊙ unpack(packed)); the pack group (128: 2 bits a weight,
    256: 1 bit) follows from the words' row count.  On the card the mask is
    expanded on the W tile on its way to the MMA (in registers in the WMMA
    loop, in shared memory in the Hopper one), and neither the unpacked
    mask nor the masked weight exists in memory.  Differentiable in x and
    w."""
    if _needs_graph(x, w):
        return _MaskedMatmulPacked.apply(x, w, packed, _loop)
    return _masked_matmul_packed_fwd(x, w, packed, _loop)


def sparse_lora_matmul(x, w, mask, lora_a, lora_b, scale: float, *,
                       out_dtype=None, _loop=None):
    """y = x @ ((w + lora_a·lora_b·scale) ⊙ mask); on the card the merged
    weight never exists in memory.  Differentiable in x, w, A and B.
    ``out_dtype``: as ``masked_matmul``'s."""
    out32 = _out32(x, out_dtype)
    if _needs_graph(x, w, lora_a, lora_b):
        return _SparseLoraMatmul.apply(x, w, mask, lora_a, lora_b,
                                       float(scale), _loop, out32)
    if x.device.type == "cpu":
        return sparse_lora_matmul_ref(x, w, mask, lora_a, lora_b, scale,
                                      torch.float32 if out32 else None)
    return _sparse_lora_cuda(x, w, mask, lora_a, lora_b, scale, _loop,
                             out32=out32)


def _out32(x, out_dtype) -> bool:
    """Whether a bf16 product is asked for its fp32 sums."""
    if out_dtype not in (None, x.dtype, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: the product's dtype or "
                        "float32")
    return out_dtype == torch.float32 and x.dtype == torch.bfloat16


def _masked_matmul_fwd(x, w, mask, loop=None, out32=False):
    if x.device.type == "cpu":
        return masked_matmul_ref(x, w, mask,
                                 torch.float32 if out32 else None)
    return _masked_matmul_cuda(x, w, mask, loop, out32=out32)


def _masked_matmul_packed_fwd(x, w, packed, loop=None):
    if x.device.type == "cpu":
        return masked_matmul_packed_ref(x, w, packed)
    return _masked_matmul_packed_cuda(x, w, packed, loop)


# the WMMA loop's output tile and K step (csrc/tile_mma.cuh)
_BM, _BN, _BK = 128, 128, 32
# largest adapter rank the sparse-LoRA kernel stages (as the TPU kernel)
MAX_LORA_RANK = 128
# the main loops of one bf16 or float32 launch
WGMMA, WMMA, FP32, DECODE = "wgmma", "wmma", "fp32", "decode"
# adapter ranks the Hopper loop holds in registers (0: no adapter)
WGMMA_RANKS = (0, 2, 4, 8)


def split_k(m: int, n: int, k: int, sms: int):
    """(splits, k_split) for the WMMA loop: when the output tiles cannot
    fill the card, split K so that about two blocks per SM stream the
    weight, each split at least 4 K steps long."""
    tiles = -(-m // _BM) * -(-n // _BN)
    splits = 1
    if tiles < sms:
        splits = max(1, min(-(-2 * sms // tiles), k // (4 * _BK)))
    k_split = -(-(-(-k // splits)) // _BK) * _BK
    return -(-k // k_split), k_split


# the decode kernel (csrc/matmul_decode.cu): M rows it takes, weight
# columns a block, the unit of its K splits (the larger pack group, so
# every mask form of a shape splits alike and no split straddles a group),
# the most splits a cluster holds
DECODE_MAX_M = 64
DECODE_BN = 64
DECODE_K_UNIT = 256
DECODE_MAX_SPLITS = 8


def plan_decode(m: int, n: int, k: int, sms: int, int8: bool = False):
    """(BN, splits, k_split) of one decode-kernel launch: column tiles of
    BN, each split over K into ``splits`` blocks of ``k_split`` rows (a
    multiple of DECODE_K_UNIT; one cluster a tile; each split non-empty,
    at most DECODE_MAX_SPLITS) so that there are at least half as many
    blocks as SMs for bf16 weights and as many for int8 codes: a bf16
    block's loads bound it, and fewer, longer blocks pay the split-K sum
    less often; an int8 block's fragment build bounds it, and more blocks
    share that work (``scripts/torch_decode_trace.py --splits`` times the
    choices).  The same for every mask kind of a weight form, so the
    bit-equalities between them hold."""
    tiles = -(-n // DECODE_BN)
    units = -(-k // DECODE_K_UNIT)
    target = sms if int8 else sms // 2
    splits = max(1, min(DECODE_MAX_SPLITS, units, -(-target // tiles)))
    per = -(-units // splits)
    return DECODE_BN, -(-units // per), per * DECODE_K_UNIT


# the Hopper loop (csrc/wgmma_tile.cuh): its output tile, the unit of its
# K splits (the larger pack group: every mask form splits alike and no
# split straddles a group), and the most splits a cluster holds
WGMMA_BM, WGMMA_BN = 256, 128
WGMMA_K_UNIT = 256
WGMMA_MAX_SPLITS = 8


def wgmma_wave(sms: int) -> int:
    """The blocks one wave of the Hopper loop's split clusters holds: 5/6
    of the SMs (one block an SM; a cluster's blocks share a GPC, and the
    GPCs' SM counts leave SMs over at clusters of 3 and more)."""
    return 5 * sms // 6


def plan_wgmma(m: int, n: int, k: int, sms: int):
    """(splits, k_split) of one Hopper-loop launch.  Where the 256 × 128
    output tiles fill a wave, one split over all of K: (1, k).  Where they
    do not, K splits across a cluster of ``splits`` blocks of ``k_split``
    rows (a multiple of WGMMA_K_UNIT, each split non-empty): the most
    splits, at most WGMMA_MAX_SPLITS, whose tiles × splits blocks still fit
    one wave (``wgmma_wave``).  A second wave costs more than a split
    saves: measured on an H100 at every prefill and training shape by
    ``scripts/torch_wgmma_check.py --splits`` (T5 wi prefill, 80 tiles:
    one split 0.0406 ms, three 0.0609; T5 qkvo, 32 tiles: three splits
    0.0261, one 0.0392).  The same for every mask kind and weight form of
    a shape, so the bit-equalities between them hold."""
    tiles = -(-m // WGMMA_BM) * -(-n // WGMMA_BN)
    units = -(-k // WGMMA_K_UNIT)
    want = min(WGMMA_MAX_SPLITS, units, wgmma_wave(sms) // tiles)
    if want <= 1:
        return 1, k
    per = -(-units // want)
    splits = -(-units // per)
    return (1, k) if splits == 1 else (splits, per * WGMMA_K_UNIT)


def plan(m: int, n: int, k: int, sms: int, *, bf16: bool = True,
         aligned: bool = True, rank: int = 0, int8: bool = False):
    """(loop, splits, k_split) of one tiled-matmul launch, from the shape
    and the alignment alone (no launch is retried on another loop):

    - float32: the CUDA-core loop, all of K in one block: (FP32, 1, k);
    - bf16 that TMA can take (``aligned``: 16-byte aligned bases; and
      K % 8 == 0, N % 16 == 0 for 16-byte strides of x, W, int8 codes and
      bool masks) with no adapter at M ≤ DECODE_MAX_M: the decode kernel,
      (DECODE, splits, k_split) from ``plan_decode`` (``int8``: the
      weights are int8 codes);
    - bf16 that TMA can take above DECODE_MAX_M with an adapter rank the
      Hopper loop holds (WGMMA_RANKS): the Hopper loop, (WGMMA, splits,
      k_split) from ``plan_wgmma`` — one split where the output tiles fill
      the card, split-K across a cluster where they do not;
    - any other bf16 (misaligned, K % 8, N % 16, another rank, an adapter
      at decode-sized M): the WMMA loop, (WMMA, splits, k_split) from
      ``split_k``.

    Every mask kind of a weight form is planned alike (bool and packed
    bf16; int8 with no, bool or packed mask), so at every shape they take
    the same loop and splits and stay bit-equal."""
    if not bf16:
        return FP32, 1, k
    tma = aligned and k % 8 == 0 and n % 16 == 0
    if tma and rank == 0 and m <= DECODE_MAX_M:
        _, splits, k_split = plan_decode(m, n, k, sms, int8)
        return DECODE, splits, k_split
    if tma and rank in WGMMA_RANKS and m > DECODE_MAX_M:
        return WGMMA, *plan_wgmma(m, n, k, sms)
    return WMMA, *split_k(m, n, k, sms)


def wmma_reason(m: int, n: int, k: int, aligned: bool, rank: int) -> str:
    """Why ``plan`` gives an unforced bf16 launch the WMMA loop."""
    if not aligned:
        return "a base not 16-byte aligned"
    if k % 8:
        return "K % 8 != 0"
    if n % 16:
        return "N % 16 != 0"
    if rank not in WGMMA_RANKS:
        return f"adapter rank {rank}"
    return f"an adapter at M <= {DECODE_MAX_M}"


def _mask_rows(w, mask, packed: bool) -> int:
    """The row count ``mask`` must have for ``w``: in (bool), or the word
    rows of a pack layout for in rows (-1 when there is none)."""
    k = w.shape[0]
    if not packed:
        return k
    try:
        infer_pack_group(k, mask.shape[0])
    except ValueError:
        return -1
    return mask.shape[0]


def _check_inputs(x, w, mask, what="masked_matmul", packed=False):
    """Raise the specific error for inputs the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if w.ndim != 2 or mask.ndim != 2 or x.shape[-1] != w.shape[0] \
            or mask.shape != (_mask_rows(w, mask, packed), w.shape[1]):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, mask {tuple(mask.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x {x.dtype} and w {w.dtype} must "
                        "both be bfloat16 or both float32")
    if packed != is_packed(mask) or not (packed or mask.dtype == torch.bool):
        raise TypeError(f"{what}: mask must be "
                        f"{'packed 32-bit words' if packed else 'bool'}, "
                        f"got {mask.dtype}")
    if w.device != x.device or mask.device != x.device:
        raise ValueError(f"{what}: x, w and mask must share a device")
    raise ValueError(f"{what}: w and mask must be contiguous")


def _check_lora(x, w, lora_a, lora_b):
    k, n = w.shape
    r = lora_a.shape[-1] if lora_a.ndim == 2 else -1
    if lora_a.shape != (k, r) or lora_b.shape != (r, n) \
            or not 0 < r <= MAX_LORA_RANK:
        raise ValueError(f"sparse_lora_matmul: A {tuple(lora_a.shape)} and "
                         f"B {tuple(lora_b.shape)} for w {(k, n)}, rank "
                         f"1..{MAX_LORA_RANK}")
    if lora_a.dtype != x.dtype or lora_b.dtype != x.dtype:
        raise TypeError(f"sparse_lora_matmul: A {lora_a.dtype} and B "
                        f"{lora_b.dtype} must match x {x.dtype}")
    if lora_a.device != x.device or lora_b.device != x.device:
        raise ValueError("sparse_lora_matmul: A and B must share x's device")


_DTYPES = (torch.bfloat16, torch.float32)


def _valid(x, w, mask, packed: bool = False) -> bool:
    dev = x.device
    return (dev.type == "cuda" and w.ndim == 2 and mask.ndim == 2
            and mask.shape == (_mask_rows(w, mask, packed), w.shape[1])
            and (is_packed(mask) if packed else mask.dtype == torch.bool)
            and x.shape[-1] == w.shape[0] and x.dtype == w.dtype
            and x.dtype in _DTYPES and w.device == dev and mask.device == dev
            and w.is_contiguous() and mask.is_contiguous())


def _launch(fn_bf16, fn_f32, x, w, mask, args=(), w_align=16, mask_align=8,
            fn_wgmma=None, fn_decode=None, extra_ptrs=(), rank=0, loop=None,
            out32=False):
    """Shared launch of the tiled matmul kernels (masked, packed,
    sparse-LoRA, int8): flatten x, allocate y (and the WMMA loop's split-K
    workspace), ``plan`` the loop — the Hopper or decode one only where x,
    W, the mask and ``extra_ptrs`` are 16-byte aligned — pick the WMMA
    loop's vectorized loads, launch, and count the launch by loop
    (``count_route``) when it succeeded.  ``fn_wgmma`` is called as the
    float32 entry point with (splits, k_split) before the stream;
    ``fn_decode`` as (x, w, mask, y, m, n, k, splits, k_split, stream)
    pointers and ints.  ``args`` go after the mask pointer; ``mask`` may be
    None (no pointer).  ``loop`` = WMMA forces the WMMA loop.  ``out32``: y
    in float32 (the entry points given write it unrounded).  Returns (y,
    the launch's error code or None when an empty shape left nothing to
    launch)."""
    if loop not in (None, WMMA):
        raise ValueError(f"loop {loop!r}: only {WMMA!r} can be forced")
    dev = x.device
    k, n = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.float32 if out32 else x.dtype,
                    device=dev)
    if m == 0 or n == 0:
        return y.reshape(*lead, n), None
    if k == 0:
        return y.zero_().reshape(*lead, n), None
    stream = _cuda.stream_ptr(dev)
    mask_ptr = None if mask is None else mask.data_ptr()
    ptrs = (x2.data_ptr(), w.data_ptr(), mask_ptr, *extra_ptrs)
    aligned = all(p is None or p % 16 == 0 for p in ptrs)
    bf16 = x.dtype == torch.bfloat16
    route, splits, k_split = plan(m, n, k, _cuda.sm_count(dev), bf16=bf16,
                                  aligned=aligned and loop is None,
                                  rank=rank, int8=w.dtype == torch.int8)
    if route == DECODE:
        err = fn_decode(x2.data_ptr(), w.data_ptr(), mask_ptr, y.data_ptr(),
                        m, n, k, splits, k_split, stream)
    elif route == WGMMA:
        err = fn_wgmma(x2.data_ptr(), w.data_ptr(), mask_ptr, *args,
                       y.data_ptr(), m, n, k, splits, k_split, stream)
    elif route == WMMA:
        vec = int(k % 8 == 0 and n % 8 == 0
                  and x2.data_ptr() % 16 == 0 and w.data_ptr() % w_align == 0
                  and (mask is None or mask_ptr % mask_align == 0))
        work = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
                if splits > 1 else None)
        err = fn_bf16(x2.data_ptr(), w.data_ptr(), mask_ptr, *args,
                      y.data_ptr(), None if work is None else work.data_ptr(),
                      m, n, k, splits, k_split, vec, stream)
    else:
        err = fn_f32(x2.data_ptr(), w.data_ptr(), mask_ptr, *args,
                     y.data_ptr(), m, n, k, stream)
    if err == 0:
        why = None
        if route == WMMA:
            why = "forced" if loop else wmma_reason(m, n, k, aligned, rank)
        count_route(route, (m, n, k, rank, why))
    return y.reshape(*lead, n), err


def _wgmma(kind: str):
    """The Hopper loop's entry point of ``kind`` (csrc/masked_matmul_wgmma.cu,
    built on first use)."""
    return getattr(_cuda.library("masked_matmul_wgmma"), f"{kind}_wgmma")


def _decode(w_int8: bool, mask_kind: int, group: int = 0, scale=None):
    """The decode kernel's entry point (csrc/matmul_decode.cu, built on
    first use) for one weight form and mask kind (0 none, 1 bool, 2
    packed words of ``group``), called as ``_launch``'s ``fn_decode``."""
    fn = _cuda.library("matmul_decode").matmul_decode

    def launch(x, w, mask, y, m, n, k, splits, k_split, stream):
        return fn(x, w, int(w_int8), mask, mask_kind, group, scale, y, m, n,
                  k, splits, k_split, stream)
    return launch


def count_route(route, call: tuple) -> None:
    """Count a launch that ran, by loop and by (M, N, K, loop); a WMMA-loop
    one also under its ``call``: (M, N, K, rank, why the other loops
    refused it)."""
    global wgmma_launches, decode_launches, wmma_launches
    key = (*call[:3], route)
    shape_launches[key] = shape_launches.get(key, 0) + 1
    if route == WGMMA:
        wgmma_launches += 1
    elif route == DECODE:
        decode_launches += 1
    elif route == WMMA:
        wmma_launches += 1
        wmma_calls[call] = wmma_calls.get(call, 0) + 1


def _decode_out32(x, w, mask, y, m, n, k, splits, k_split, stream):
    """The decode kernel's bool-mask entry point with an fp32 y."""
    return _cuda.library("matmul_decode").matmul_decode_out32(
        x, w, mask, y, m, n, k, splits, k_split, stream)


def _masked_matmul_cuda(x, w, mask, loop=None, out32=False):
    global launches
    if not _valid(x, w, mask):
        _check_inputs(x, w, mask)
    lib = _cuda.library("masked_matmul")
    if out32:
        y, err = _launch(lib.masked_matmul_out32_bf16, None, x, w, mask,
                         fn_wgmma=_wgmma("masked_matmul_out32"),
                         fn_decode=_decode_out32, loop=loop, out32=True)
    else:
        y, err = _launch(lib.masked_matmul_bf16, lib.masked_matmul_f32, x, w,
                         mask, fn_wgmma=_wgmma("masked_matmul"),
                         fn_decode=_decode(False, 1), loop=loop)
    if err is not None:
        _cuda.check(err, "masked_matmul")
        launches += 1
    return y


def _masked_matmul_packed_cuda(x, w, packed, loop=None):
    global packed_launches
    if not _valid(x, w, packed, packed=True):
        _check_inputs(x, w, packed, "masked_matmul_packed", packed=True)
    group = infer_pack_group(w.shape[0], packed.shape[0])
    lib = _cuda.library("masked_matmul")
    # each 8-column chunk reads its 8 words as two 16-byte loads
    y, err = _launch(lib.masked_matmul_packed_bf16,
                     lib.masked_matmul_packed_f32, x, w, packed, (group,),
                     mask_align=16, fn_wgmma=_wgmma("masked_matmul_packed"),
                     fn_decode=_decode(False, 2, group), loop=loop)
    if err is not None:
        _cuda.check(err, "masked_matmul_packed")
        packed_launches += 1
    return y


def _sparse_lora_cuda(x, w, mask, lora_a, lora_b, scale, loop=None,
                      out32=False):
    global lora_launches
    if not _valid(x, w, mask):
        _check_inputs(x, w, mask, "sparse_lora_matmul")
    if not (lora_a.ndim == 2 and lora_b.ndim == 2
            and lora_a.shape[0] == w.shape[0]
            and lora_b.shape == (lora_a.shape[1], w.shape[1])
            and 0 < lora_a.shape[1] <= MAX_LORA_RANK
            and lora_a.dtype == x.dtype and lora_b.dtype == x.dtype
            and lora_a.device == x.device and lora_b.device == x.device):
        _check_lora(x, w, lora_a, lora_b)
    lib = _cuda.library("masked_matmul")
    a, b = lora_a.contiguous(), lora_b.contiguous()
    kind = "sparse_lora_matmul_out32" if out32 else "sparse_lora_matmul"
    y, err = _launch(
        getattr(lib, kind + "_bf16"), lib.sparse_lora_matmul_f32, x, w, mask,
        (a.data_ptr(), b.data_ptr(), a.shape[1], float(scale)),
        fn_wgmma=_wgmma(kind), extra_ptrs=(a.data_ptr(), b.data_ptr()),
        rank=a.shape[1], loop=loop, out32=out32)
    if err is not None:
        _cuda.check(err, "sparse_lora_matmul")
        lora_launches += 1
        key = (y.numel() // w.shape[1], w.shape[1], w.shape[0], a.shape[1])
        lora_shape_launches[key] = lora_shape_launches.get(key, 0) + 1
    return y
