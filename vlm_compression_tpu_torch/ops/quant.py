"""Weight-only int8 quantization (port of the int8 part of
``vlm_compression_tpu/ops/quant.py``).

Per-output-channel absmax symmetric quantization: for a kernel W (in, out),

    scale_j = max_i |W_ij| / 127        q_ij = round(W_ij / scale_j) ∈ int8

The product keeps the weights int8 at rest and applies the scale to the
output column: y = (x @ (q ⊙ M)) · scale, the fp32 sum scaled and then
rounded to x's dtype once — the JAX package's default path
(``_int8_matmul_ref`` and ``int8_matmul``).  Masks (bool or bit-packed)
compose: the mask zeroes codes before the product.

``int8_matmul`` runs the plain version on CPU tensors and a hand-written
kernel on CUDA tensors, always (launch or raise): at decode-sized M the
decode kernel of ``csrc/matmul_decode.cu`` (the bool and packed matmuls'
decode launches run it too), above it the Hopper TMA + wgmma loop of
``csrc/int8_matmul_wgmma.cu`` (the bf16 matmuls' loop, the codes converted
to bf16 in shared memory; split-K across a cluster where the tiles do not
fill the card), and only what TMA cannot take on the WMMA loop of
``csrc/int8_matmul.cu`` (``ops/masked_linear.plan`` decides from the shape
and alignment, whatever the mask kind):
the JAX package's opt-in (``use_pallas_int8_matmul``, off by default)
followed a measurement of Mosaic's int8 relayout on a TPU v5e that says
nothing about this card, and the port decides dispatch by H100
measurements.  ``int8_launches`` counts kernel launches (and
``masked_linear``'s route counters count them by loop).

Int4 (``quantize_weight_int4`` … ``quantize_model_int4_``) keeps the JAX
package's layout bit for bit: grouped absmax scales (K/g, N), codes in
[-7, 7], two nibbles a byte (row 2i low, row 2i+1 high).  ``int4_matmul``
dequantizes the weight to x's dtype and, with a mask, runs the masked
products of ``ops/masked_linear`` (their kernels on the card); without
one, a plain product, as the JAX package's ``dot_general``.

W8A8 (``int8_matmul_dynamic``, ``int8_matmul_outlier``) quantizes the
activations per row at run time and multiplies int8 by int8 into int32
with ``torch._int_mm`` (rows padded with zeros to 17 where the card's
build refuses 16 or fewer: exact, int32 sums are exact), then rescales in
the JAX package's order.  ``select_int8_matmul`` picks the product SparseLinear's
int8 paths run, from two switches of this module that the JAX package
also keeps as module state (``use_dynamic_int8``, ``set_int8_outliers``);
``int8_switches`` restores both on exit.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch import nn

from vlm_compression_tpu_torch.ops import _cuda
from vlm_compression_tpu_torch.ops import masked_linear as ML
from vlm_compression_tpu_torch.ops.bitmask import (
    infer_pack_group,
    is_packed,
    unpack_mask,
)

int8_launches = 0

# mask kinds of the kernel's C interface
_NO_MASK, _BOOL_MASK, _PACKED_MASK = 0, 1, 2


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, an IEEE division on every device: PyTorch's CUDA division by
    a Python number multiplies by its reciprocal, which rounds otherwise
    (so codes and scales on the card would differ from the CPU's)."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def quantize_weight(w: torch.Tensor):
    """(in, out) float → (q int8 (in, out), scale fp32 (out,))."""
    w32 = w.float()
    scale = div(torch.clamp(w32.abs().amax(dim=0), min=1e-12), 127.0)
    q = torch.clamp(torch.round(w32 / scale[None, :]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale[None, :]).to(dtype)


def _bool_mask(mask, k: int):
    if mask is None or not is_packed(mask):
        return mask
    return unpack_mask(mask, k, infer_pack_group(k, mask.shape[0]))


def int8_matmul_ref(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                    mask=None) -> torch.Tensor:
    """Plain version: codes to x's dtype, masked, an fp32 product, the
    scale on the fp32 output, one rounding to x's dtype."""
    qf = q.to(x.dtype)
    mask = _bool_mask(mask, q.shape[0])
    if mask is not None:
        qf = torch.where(mask, qf, torch.zeros((), dtype=qf.dtype,
                                               device=qf.device))
    out = torch.matmul(x.float(), qf.float())
    return (out * scale).to(x.dtype)


class _Int8Matmul(torch.autograd.Function):
    """Differentiable in x (the codes are frozen): dx = (g·scale)·(q⊙M)ᵀ
    in fp32, as autodiff of the JAX reference path gives."""

    @staticmethod
    def forward(ctx, x, q, scale, mask, loop):
        ctx.save_for_backward(q, scale, mask)
        return _int8_matmul_fwd(x, q, scale, mask, loop)

    @staticmethod
    def backward(ctx, g):
        q, scale, mask = ctx.saved_tensors
        qf = q.float()
        mask = _bool_mask(mask, q.shape[0])
        if mask is not None:
            qf = torch.where(mask, qf, torch.zeros((), device=qf.device))
        dx = torch.matmul(g.float() * scale, qf.t()).to(g.dtype)
        return dx, None, None, None, None


def int8_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                mask=None, *, _loop=None) -> torch.Tensor:
    """y = (x @ (q ⊙ mask)) · scale, the scale on each output column; mask
    None, bool (in, out) or packed words.  Weights stay int8 in memory; on
    the card they are dequantized per tile on chip (in registers, or in
    shared memory on the Hopper loop).  ``_loop`` =
    ``masked_linear.WMMA`` forces the WMMA loop where the plan is another
    — for timing the loops side by side on the card, not a knob of the
    model."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Int8Matmul.apply(x, q, scale, mask, _loop)
    return _int8_matmul_fwd(x, q, scale, mask, _loop)


def _int8_matmul_fwd(x, q, scale, mask, loop=None):
    if x.device.type == "cpu":
        return int8_matmul_ref(x, q, scale, mask)
    return _int8_matmul_cuda(x, q, scale, mask, loop)


def _check_int8(x, q, scale, mask):
    what = "int8_matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if q.ndim != 2 or x.shape[-1] != q.shape[0] \
            or tuple(scale.shape) != (q.shape[1],):
        raise ValueError(f"{what}: shapes x {tuple(x.shape)}, q "
                         f"{tuple(q.shape)}, scale {tuple(scale.shape)}")
    if mask is not None:
        rows = q.shape[0]
        if is_packed(mask):
            try:
                infer_pack_group(rows, mask.shape[0])
                rows = mask.shape[0]
            except ValueError:
                rows = -1
        if mask.ndim != 2 or tuple(mask.shape) != (rows, q.shape[1]):
            raise ValueError(f"{what}: mask {tuple(mask.shape)} for q "
                             f"{tuple(q.shape)}")
        if mask.dtype != torch.bool and not is_packed(mask):
            raise TypeError(f"{what}: mask must be bool or packed 32-bit "
                            f"words, got {mask.dtype}")
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or x.dtype not in ML._DTYPES:
        raise TypeError(f"{what}: q {q.dtype} must be int8, scale "
                        f"{scale.dtype} float32, x {x.dtype} bfloat16 or "
                        "float32")
    if any(t.device != x.device for t in (q, scale) + (
            () if mask is None else (mask,))):
        raise ValueError(f"{what}: x, q, scale and mask must share a device")
    raise ValueError(f"{what}: q, scale and mask must be contiguous")


def _valid_int8(x, q, scale, mask) -> bool:
    dev = x.device
    if not (dev.type == "cuda" and q.ndim == 2 and q.dtype == torch.int8
            and x.shape[-1] == q.shape[0] and x.dtype in ML._DTYPES
            and scale.dtype == torch.float32
            and tuple(scale.shape) == (q.shape[1],)
            and q.device == dev and scale.device == dev
            and q.is_contiguous() and scale.is_contiguous()):
        return False
    if mask is None:
        return True
    packed = is_packed(mask)
    return (mask.ndim == 2 and mask.device == dev and mask.is_contiguous()
            and (packed or mask.dtype == torch.bool)
            and mask.shape == (ML._mask_rows(q, mask, packed), q.shape[1]))


def _int8_matmul_cuda(x, q, scale, mask, loop=None):
    global int8_launches
    if not _valid_int8(x, q, scale, mask):
        _check_int8(x, q, scale, mask)
    if mask is None:
        kind, group, mask_align = _NO_MASK, 0, 8
    elif is_packed(mask):
        kind, mask_align = _PACKED_MASK, 16
        group = infer_pack_group(q.shape[0], mask.shape[0])
    else:
        kind, group, mask_align = _BOOL_MASK, 0, 8
    lib = _cuda.library("int8_matmul")
    y, err = ML._launch(
        lib.int8_matmul_bf16, lib.int8_matmul_f32, x, q, mask,
        (kind, group, scale.data_ptr()), w_align=8, mask_align=mask_align,
        fn_wgmma=_cuda.library("int8_matmul_wgmma").int8_matmul_wgmma,
        fn_decode=ML._decode(True, kind, group, scale.data_ptr()), loop=loop)
    if err is not None:
        _cuda.check(err, "int8_matmul")
        int8_launches += 1
    return y


def quantize_params_tree(params: dict, min_size: int = 0) -> dict:
    """Quantize every 2-D floating ``kernel`` of at least ``min_size``
    elements to int8 with a ``kernel_scale`` sibling (a nested dict of
    tensors, as the JAX package's params tree)."""
    if not isinstance(params, dict):
        return params
    out = {k: quantize_params_tree(v, min_size) if isinstance(v, dict) else v
           for k, v in params.items()}
    kern = out.get("kernel")
    if (isinstance(kern, torch.Tensor) and kern.ndim == 2
            and kern.is_floating_point() and kern.numel() >= min_size):
        out["kernel"], out["kernel_scale"] = quantize_weight(kern)
    return out


def dequantize_params_tree(params: dict, dtype=torch.float32) -> dict:
    """Inverse of ``quantize_params_tree`` (lossy: q·scale)."""
    if not isinstance(params, dict):
        return params
    out = {k: dequantize_params_tree(v, dtype) if isinstance(v, dict) else v
           for k, v in params.items()}
    kern = out.get("kernel")
    if isinstance(kern, torch.Tensor) and kern.dtype == torch.int8 \
            and "kernel_scale" in out:
        out["kernel"] = dequantize_weight(kern, out.pop("kernel_scale"), dtype)
    return out


@torch.no_grad()
def quantize_model_int8_(model: nn.Module) -> nn.Module:
    """Quantize the floating kernel of every SparseLinear of ``model`` in
    place (the port of ``evaluate.py --quantize_int8``): each becomes int8
    codes with a ``kernel_scale`` fp32 (out,) buffer.  Masks stay as they
    are."""
    from vlm_compression_tpu_torch.models.layers import (
        SparseLinear,
        set_int8_kernel,
    )

    for m in model.modules():
        if isinstance(m, SparseLinear) and m.kernel is not None \
                and m.kernel.is_floating_point():
            set_int8_kernel(m, *quantize_weight(m.kernel))
    return model


# ---------------------------------------------------------------------------
# int4 weights: grouped absmax symmetric scales along the input rows, codes
# in [-7, 7], two nibbles a uint8 byte (row 2i low, row 2i+1 high)
# ---------------------------------------------------------------------------

INT4_GROUP = 128


def quantize_weight_int4(w: torch.Tensor, group: int = INT4_GROUP):
    """(in, out) float → (packed uint8 (in/2, out), scale fp32 (in/g, out));
    in must be a multiple of the group, the group even."""
    k, n = w.shape
    if k % group or group % 2:
        raise ValueError(f"in_features {k} not a multiple of group {group}")
    wf = w.float().reshape(k // group, group, n)
    scale = div(torch.clamp(wf.abs().amax(dim=1), min=1e-12), 7.0)
    q = torch.clamp(torch.round(wf / scale[:, None, :]), -7, 7)
    q = q.to(torch.int32).reshape(k, n)
    packed = (q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)
    return packed.to(torch.uint8), scale


def unpack_int4(packed: torch.Tensor, dtype=torch.int8) -> torch.Tensor:
    """(in/2, out) uint8 → (in, out) sign-extended values."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    lo = lo - 16 * (lo >= 8).to(torch.int32)
    hi = hi - 16 * (hi >= 8).to(torch.int32)
    k2, n = packed.shape
    return torch.stack([lo, hi], dim=1).reshape(2 * k2, n).to(dtype)


def dequantize_weight_int4(packed: torch.Tensor, scale: torch.Tensor,
                           dtype=torch.float32) -> torch.Tensor:
    k = 2 * packed.shape[0]
    g = k // scale.shape[0]
    q = unpack_int4(packed, torch.float32).reshape(k // g, g, scale.shape[1])
    return (q * scale[:, None, :]).reshape(k, -1).to(dtype)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                mask=None) -> torch.Tensor:
    """y = x @ (dequant(packed, scale) [⊙ mask]): the weight dequantized to
    x's dtype, then the masked product (bool or packed; on the card the
    masked and packed matmul kernels) or, without a mask, a plain one."""
    eff = dequantize_weight_int4(packed, scale, x.dtype)
    if mask is None:
        return x @ eff
    if is_packed(mask):
        return ML.masked_matmul_packed(x, eff, mask)
    return ML.masked_matmul(x, eff, mask)


def quantize_params_tree_int4(params: dict, group: int = INT4_GROUP,
                              min_size: int = 0) -> dict:
    """Every 2-D floating ``kernel`` (at least ``min_size`` elements, rows a
    multiple of the group) → ``kernel_q4`` + 2-D ``kernel_scale``; the
    float ``kernel`` entry is removed."""
    if not isinstance(params, dict):
        return params
    out = {k: quantize_params_tree_int4(v, group, min_size)
           if isinstance(v, dict) else v for k, v in params.items()}
    kern = out.get("kernel")
    if (isinstance(kern, torch.Tensor) and kern.ndim == 2
            and kern.is_floating_point() and kern.numel() >= min_size
            and kern.shape[0] % group == 0):
        del out["kernel"]
        out["kernel_q4"], out["kernel_scale"] = quantize_weight_int4(kern,
                                                                     group)
    return out


@torch.no_grad()
def quantize_model_int4_(model: nn.Module, group: int = INT4_GROUP
                         ) -> nn.Module:
    """Quantize the floating kernel of every SparseLinear of ``model`` whose
    rows are a multiple of ``group`` to int4 in place (the port of
    ``evaluate.py --quantize_int4``; int8 kernels are left as they are, as
    ``quantize_params_tree_int4`` leaves them).  Masks stay."""
    from vlm_compression_tpu_torch.models.layers import (
        SparseLinear,
        set_int4_kernel,
    )

    for m in model.modules():
        if isinstance(m, SparseLinear) and m.kernel is not None \
                and m.kernel.is_floating_point() \
                and m.in_features % group == 0:
            set_int4_kernel(m, *quantize_weight_int4(m.kernel, group))
    return model


# ---------------------------------------------------------------------------
# W8A8: activations quantized per row at run time, int8 × int8 → int32
# ---------------------------------------------------------------------------

# the card's ``_int_mm`` refuses 16 rows or fewer and widths (K, N) that
# are not a multiple of 8, and takes any other row count
# (scripts/torch_int_mm_probe.py); zero rows and columns are exact in int32
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _pad_to(t: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    if t.shape == (rows, cols):
        return t
    return torch.nn.functional.pad(t, (0, cols - t.shape[1],
                                       0, rows - t.shape[0]))


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) × int8 (K, N) → int32 (M, N) by ``torch._int_mm``, the
    operands padded with zeros only where the card's build refuses them:
    rows up to 17, widths up to a multiple of 8."""
    m, k = a.shape
    n = b.shape[1]

    def up(v):
        return -(-v // _INT_MM_ALIGN) * _INT_MM_ALIGN

    mp, kp, np_ = max(m, _INT_MM_MIN_ROWS), up(k), up(n)
    acc = torch._int_mm(_pad_to(a, mp, kp), _pad_to(b, kp, np_))
    return acc if (mp, np_) == (m, n) else acc[:m, :n]


def int8_matmul_dynamic(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        mask=None) -> torch.Tensor:
    """True int8 × int8 product: activations quantized per row (absmax
    symmetric), an int32 accumulation, the int32 result rescaled by the
    row's activation scale and the column's weight scale."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float()
    sx = div(torch.clamp(x2.abs().amax(dim=1), min=1e-12), 127.0)
    xq = torch.clamp(torch.round(x2 / sx[:, None]), -127, 127).to(torch.int8)
    mask = _bool_mask(mask, q.shape[0])
    qw = q if mask is None else torch.where(
        mask, q, torch.zeros((), dtype=q.dtype, device=q.device))
    acc = int_mm(xq, qw)
    y = acc.float() * sx[:, None] * scale[None, :]
    return y.reshape(*lead, q.shape[1]).to(x.dtype)


def top_k_indices(v: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D tensor, ties to the lower
    index (``lax.top_k``'s order; ``torch.topk`` gives none)."""
    return torch.sort(v, descending=True, stable=True)[1][:k]


def int8_matmul_outlier(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        mask=None, num_outliers: int = 32) -> torch.Tensor:
    """W8A8 with the outlier decomposition of LLM.int8: the
    ``num_outliers`` activation columns of largest magnitude stay in fp32
    against their dequantized weight rows; the other columns go through
    ``int8_matmul_dynamic`` with the outlier columns zeroed."""
    lead = x.shape[:-1]
    k_in, n = q.shape
    x2 = x.reshape(-1, k_in).float()
    k = min(int(num_outliers), k_in)
    idx = top_k_indices(x2.abs().amax(dim=0), k)
    x_out = x2[:, idx]
    w_rows = q[idx].float() * scale[None, :]
    mask = _bool_mask(mask, k_in)
    if mask is not None:
        w_rows = torch.where(mask[idx], w_rows,
                             torch.zeros((), device=w_rows.device))
    y_out = torch.matmul(x_out, w_rows)
    keep = torch.ones(k_in, dtype=torch.bool, device=x.device)
    keep[idx] = False
    x_rest = torch.where(keep[None, :], x2,
                         torch.zeros((), device=x2.device))
    y_int = int8_matmul_dynamic(x_rest, q, scale, mask).float()
    y = y_int.reshape(-1, n) + y_out
    return y.reshape(*lead, n).to(x.dtype)


# SparseLinear's int8 product: weight-only (default), W8A8
# (``use_dynamic_int8``), W8A8 with outlier columns (``set_int8_outliers``
# above 0), as the JAX package's module switches
_DYNAMIC_INT8 = False
_INT8_OUTLIERS = 0


def set_int8_outliers(k: int) -> None:
    global _INT8_OUTLIERS
    _INT8_OUTLIERS = int(k)


def int8_outliers() -> int:
    return _INT8_OUTLIERS


def use_dynamic_int8(enable: bool) -> None:
    global _DYNAMIC_INT8
    _DYNAMIC_INT8 = bool(enable)


def dynamic_int8_enabled() -> bool:
    return _DYNAMIC_INT8


def select_int8_matmul():
    """The int8 product SparseLinear's quantized paths run: ``int8_matmul``
    (weight-only, the int8 kernel on the card) by default,
    ``int8_matmul_dynamic`` under ``use_dynamic_int8(True)``,
    ``int8_matmul_outlier`` with ``set_int8_outliers(k > 0)`` too."""
    if not _DYNAMIC_INT8:
        return int8_matmul
    if _INT8_OUTLIERS > 0:
        return functools.partial(int8_matmul_outlier,
                                 num_outliers=_INT8_OUTLIERS)
    return int8_matmul_dynamic


@contextlib.contextmanager
def int8_switches():
    """Restore both W8A8 switches on exit, on success or on error."""
    saved = (_DYNAMIC_INT8, _INT8_OUTLIERS)
    try:
        yield
    finally:
        use_dynamic_int8(saved[0])
        set_int8_outliers(saved[1])
