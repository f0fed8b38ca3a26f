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

Not ported yet: the W8A8 products (``int8_matmul_dynamic``,
``int8_matmul_outlier``, ``select_int8_matmul``) and int4; SparseLinear
raises for an int4 kernel.
"""

from __future__ import annotations

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


def quantize_weight(w: torch.Tensor):
    """(in, out) float → (q int8 (in, out), scale fp32 (out,))."""
    w32 = w.float()
    scale = torch.clamp(w32.abs().amax(dim=0), min=1e-12) / 127.0
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
        if isinstance(m, SparseLinear) and m.kernel.is_floating_point():
            set_int8_kernel(m, *quantize_weight(m.kernel))
    return model
