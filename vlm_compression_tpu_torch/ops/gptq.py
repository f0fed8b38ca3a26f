"""GPTQ: OBS post-training weight quantization (port of
``vlm_compression_tpu/ops/gptq.py``).

The quantization twin of SparseGPT: the same calibration Hessians, the
blocked column sweep with error feedback, where each column is rounded to
its grid point instead of zeroed, and the rounding error goes forward
through ``W[:, i:] -= err · H⁻¹[i, i:]``.

  * symmetric or asymmetric grids, 2-8 bits, scales grouped along the input
    rows (``groupsize`` columns a (unit, group) scale), set from the
    error-fed weights when the sweep enters the group;
  * ``act_order``: columns swept by decreasing Hessian diagonal (a stable
    argsort); scale groups follow the sweep order and ``perm`` is returned,
    ``W[:, perm[j]] = scale[:, j//G]·(codes[:, j] − zero[:, j//G])``;
  * joint sparse + quant: ``sparsity`` (a per-block threshold, k =
    ⌊size·s⌋ in float32, none pruned at k = 0) or n:m groups (a double
    stable argsort); pruned entries are exactly zero (their code is the
    zero point), and both errors feed forward.

The prelude is GPTQ's, not SparseGPT's: dead columns, the permutation,
±inf clamped, damped Cholesky of H, its inverse (clamped), a second damp
of that inverse by ``percdamp · mean|diag|``, and its lower Cholesky
factor transposed (the upper factor).  ``damped_cholesky`` and
``_clamp_infs`` are SparseGPT's (``ops/sparsegpt.py``).

Layout: unit-major (units, in), Hessians (in, in), fp32 with TF32 off.
Each sweep column is a handful of elementwise launches over the batch of
equal-shape linears (``gptq_quantize_batched``, as
``sparsegpt_prune_batched``).
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from vlm_compression_tpu_torch.ops.quant import div
from vlm_compression_tpu_torch.ops.sparsegpt import (
    _clamp_infs,
    damped_cholesky,
)
from vlm_compression_tpu_torch.ops.stats import (
    CalibStats,
    finalize_hessian,
    pin_fp32,
)


class GPTQResult(NamedTuple):
    weight: torch.Tensor     # (units, in) fake-quant weights, original order
    codes: torch.Tensor      # (units, in) uint8 grid codes, sweep order
    scale: torch.Tensor      # (units, ngroups) fp32
    zero: torch.Tensor       # (units, ngroups) fp32 (integer-valued)
    perm: torch.Tensor       # (in,) int32 sweep order (identity w/o act_order)
    keep_mask: torch.Tensor  # (units, in) bool, original order
    losses: torch.Tensor     # (units,) accumulated OBS losses


def _find_params(x: torch.Tensor, maxq: int, sym: bool):
    """Per-unit grid over a (…, units, G) slab: ranges stretched to hold 0,
    symmetric ranges centred on 0, an all-zero slab a [-1, 1] grid."""
    zero_t = torch.zeros((), dtype=x.dtype, device=x.device)
    xmin = torch.minimum(x.amin(dim=-1), zero_t)
    xmax = torch.maximum(x.amax(dim=-1), zero_t)
    if sym:
        xmax = torch.maximum(xmin.abs(), xmax)
        xmin = -xmax
    degenerate = (xmin == 0) & (xmax == 0)
    xmin = torch.where(degenerate, -1.0, xmin)
    xmax = torch.where(degenerate, 1.0, xmax)
    scale = div(xmax - xmin, float(maxq))
    if sym:
        zero = torch.full_like(scale, float((maxq + 1) // 2))
    else:
        zero = torch.round(-xmin / scale)
    return scale, zero


def _quantize_col(w, scale, zero, maxq):
    """(codes, fake-quant values) of ``w`` on the grid (scale, zero); the
    sweep's column step does the same in place in its block buffers."""
    q = torch.clamp(torch.round(w / scale) + zero, 0, maxq)
    return q, scale * (q - zero)


def _geometry(cols: int, groupsize: int, blocksize: int):
    """(G, B) as the JAX package settles them, with its warnings."""
    if groupsize <= 0:
        groupsize = cols
    elif cols % groupsize != 0:
        warnings.warn(
            f"gptq: groupsize {groupsize} does not divide in_features "
            f"{cols}; falling back to ONE per-tensor grid per row "
            f"(coarser than requested)", stacklevel=3)
        groupsize = cols
    if cols % blocksize != 0:
        blocksize = cols
    if blocksize % groupsize != 0 and groupsize % blocksize != 0:
        warnings.warn(
            f"gptq: groupsize {groupsize} incompatible with blocksize "
            f"{blocksize} (neither divides the other); falling back to "
            f"ONE per-tensor grid per row", stacklevel=3)
        groupsize = cols
    return groupsize, blocksize


def _prelude(W, H, act_order: bool, prune_n: int, percdamp: float):
    """Dead columns, the sweep order, and the upper factor of the damped
    H⁻¹, batched over (g, …)."""
    g, units, cols = W.shape
    dead = torch.diagonal(H, dim1=-2, dim2=-1) == 0
    H = H + torch.diag_embed(dead.to(H.dtype))
    W.masked_fill_(dead[:, None, :], 0.0)
    if act_order:
        if prune_n:
            raise ValueError("act_order is incompatible with n:m groups")
        perm = torch.argsort(-torch.diagonal(H, dim1=-2, dim2=-1), dim=-1,
                             stable=True)
        W = torch.gather(W, 2, perm[:, None, :].expand(g, units, cols))
        rows = torch.arange(g, device=H.device)[:, None, None]
        H = H[rows, perm[:, :, None], perm[:, None, :]]
    else:
        perm = torch.arange(cols, device=W.device).expand(g, cols)
    H = torch.stack([_clamp_infs(h) for h in H])
    damp = percdamp * torch.diagonal(H, dim1=-2, dim2=-1).mean(-1)
    L = damped_cholesky(H, damp)
    del H
    hinv_full = torch.stack([_clamp_infs(h)
                             for h in torch.cholesky_inverse(L)])
    del L
    damp2 = percdamp * torch.diagonal(hinv_full, dim1=-2,
                                      dim2=-1).abs().mean(-1)
    hinv = damped_cholesky(hinv_full, damp2).transpose(-2, -1).contiguous()
    return W, perm.to(torch.int32), hinv


def _block_prune(w1, d1, sparsity: float):
    """Unstructured prune mask of a block (True = prune): tmp ≤ the
    k-th smallest tmp, k = ⌊size·s⌋ formed in float32; none at k = 0."""
    tmp = w1 * w1 / (d1[:, None, :] ** 2)
    size = tmp[0].numel()
    k = int(np.floor(np.float32(size) * np.float32(sparsity)))
    if k <= 0:
        return torch.zeros_like(w1, dtype=torch.bool)
    k = min(k, size - 1)
    thresh = torch.kthvalue(tmp.reshape(tmp.shape[0], -1), k + 1, dim=1)[0]
    return tmp <= thresh[:, None, None]


@torch.no_grad()
def gptq_quantize_batched(weights_um: torch.Tensor, hessians: torch.Tensor,
                          bits: int = 4, groupsize: int = 128,
                          sym: bool = True, act_order: bool = False,
                          sparsity: float = 0.0, prune_n: int = 0,
                          prune_m: int = 0, blocksize: int = 128,
                          percdamp: float = 0.01) -> GPTQResult:
    """GPTQ of g equal-shape linears at once: weights (g, units, in),
    Hessians (g, in, in).  Returns a GPTQResult with a leading g."""
    if weights_um.is_cuda:
        pin_fp32()
    W = weights_um.float().clone()
    g, units, cols = W.shape
    out_dtype = weights_um.dtype
    maxq = (1 << bits) - 1
    W, perm, hinv = _prelude(W, hessians.float().clone(), act_order,
                             prune_n, percdamp)
    G, B = _geometry(cols, groupsize, blocksize)
    dev = W.device

    codes = torch.empty((g, units, cols), dtype=torch.float32, device=dev)
    prune = torch.zeros((g, units, cols), dtype=torch.bool, device=dev)
    scales = torch.zeros((g, units, cols // G), dtype=torch.float32,
                         device=dev)
    zeros = torch.zeros_like(scales)
    losses = torch.zeros((g, units), dtype=torch.float32, device=dev)
    sc = torch.ones((g, units, 1), dtype=torch.float32, device=dev)
    zc = torch.zeros((g, units, 1), dtype=torch.float32, device=dev)
    for i1 in range(0, cols, B):
        i2 = i1 + B
        w1 = W[..., i1:i2].clone()
        h1 = hinv[:, i1:i2, i1:i2]
        d1 = torch.diagonal(h1, dim1=-2, dim2=-1)
        p1 = prune[..., i1:i2]
        if prune_n == 0:
            p1.copy_(_block_prune(w1, d1, sparsity))
        q1 = torch.empty_like(w1)
        c1 = codes[..., i1:i2]
        diff1 = torch.empty_like(w1)
        err1 = torch.empty_like(w1)
        for i in range(B):
            j = i1 + i
            if j % G == 0:
                # G ≤ B: the group lies in the block, whose columns ≥ i are
                # current in w1; G > B: it starts here, where W is current
                # for every column ≥ i1
                slab = (w1[..., i:i + G] if G <= B else W[..., j:j + G])
                s_new, z_new = _find_params(slab, maxq, sym)
                scales[..., j // G] = s_new
                zeros[..., j // G] = z_new
                sc, zc = s_new[..., None], z_new[..., None]
            if prune_n and i % prune_m == 0:
                grp = w1[..., i:i + prune_m]
                met = grp * grp / d1[:, None, i:i + prune_m] ** 2
                order = torch.argsort(met, dim=-1, stable=True)
                rank = torch.argsort(order, dim=-1, stable=True)
                p1[..., i:i + prune_m] = rank < prune_n
            # _quantize_col, written into the block's buffers in place
            w = w1[..., i:i + 1]
            code = torch.div(w, sc, out=c1[..., i:i + 1])
            code.round_().add_(zc).clamp_(0, maxq)
            deq = torch.sub(code, zc, out=q1[..., i:i + 1]).mul_(sc)
            if prune_n or sparsity > 0:
                pr = p1[..., i:i + 1]
                deq.masked_fill_(pr, 0.0)
                torch.where(pr, zc, code, out=code)
            dcol = torch.sub(w, deq, out=diff1[..., i:i + 1])
            e = torch.div(dcol, h1[:, None, i, i:i + 1],
                          out=err1[..., i:i + 1])
            w1[..., i:] -= e * h1[:, None, i, i:]
        W[..., i1:i2] = q1
        losses += (diff1 ** 2 / (d1[:, None, :] * d1[:, None, :])).sum(-1) \
            / 2.0
        if i2 < cols:
            W[..., i2:] -= torch.matmul(err1, hinv[:, i1:i2, i2:])
    keep = ~prune
    if act_order:
        inv = torch.argsort(perm.long(), dim=-1)
        idx = inv[:, None, :].expand(g, units, cols)
        W = torch.gather(W, 2, idx)
        keep = torch.gather(keep, 2, idx)
    return GPTQResult(weight=W.to(out_dtype), codes=codes.to(torch.uint8),
                      scale=scales, zero=zeros, perm=perm, keep_mask=keep,
                      losses=losses)


def gptq_quantize(weight_um: torch.Tensor, hessian: torch.Tensor,
                  bits: int = 4, groupsize: int = 128, sym: bool = True,
                  act_order: bool = False, sparsity: float = 0.0,
                  prune_n: int = 0, prune_m: int = 0, blocksize: int = 128,
                  percdamp: float = 0.01) -> GPTQResult:
    """GPTQ of one linear: weight (units, in) in any float dtype (fp32
    inside), hessian (in, in) = (2/n)·Σ XᵀX."""
    res = gptq_quantize_batched(weight_um[None], hessian[None], bits,
                                groupsize, sym, act_order, sparsity, prune_n,
                                prune_m, blocksize, percdamp)
    return GPTQResult(*(t[0] for t in res))


def gptq_quantize_group(kernels_io: Sequence[torch.Tensor],
                        stats: Sequence[CalibStats], bits: int = 4,
                        groupsize: int = 128, sym: bool = True,
                        act_order: bool = False, sparsity: float = 0.0,
                        prune_n: int = 0, prune_m: int = 0,
                        blocksize: int = 128, percdamp: float = 0.01):
    """One batched sweep for an equal-shape group: kernels in (in, units)
    layout and their calibration stats.  Returns a tuple of (keep_mask
    (in, units), fake-quant kernel (in, units), mean loss) per member."""
    ws = torch.stack([k.t() for k in kernels_io])
    hs = torch.stack([finalize_hessian(s) for s in stats])
    res = gptq_quantize_batched(ws, hs, bits, groupsize, sym, act_order,
                                sparsity, prune_n, prune_m, blocksize,
                                percdamp)
    del ws, hs
    return tuple((res.keep_mask[i].t().contiguous(),
                  res.weight[i].t().contiguous(), res.losses[i].mean())
                 for i in range(len(kernels_io)))


def gptq_dequantize(codes: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, perm: torch.Tensor,
                    keep_mask: Optional[torch.Tensor] = None,
                    dtype=torch.float32) -> torch.Tensor:
    """The fake-quant weights from their codes:
    ``W[:, perm[j]] = scale[:, j//G] · (codes[:, j] − zero[:, j//G])``,
    then zero off ``keep_mask``."""
    units, cols = codes.shape
    G = cols // scale.shape[1]
    gi = torch.arange(cols, device=codes.device) // G
    w_sweep = scale[:, gi] * (codes.float() - zero[:, gi])
    W = torch.zeros((units, cols), dtype=torch.float32, device=codes.device)
    W[:, perm.long()] = w_sweep
    if keep_mask is not None:
        W = torch.where(keep_mask, W, 0.0)
    return W.to(dtype)


def _rtn(W: torch.Tensor, bits: int, groupsize: int, sym: bool
         ) -> torch.Tensor:
    """Round-to-nearest fake-quant of (units, cols) on grouped grids."""
    units, cols = W.shape
    maxq = (1 << bits) - 1
    if groupsize <= 0 or cols % groupsize != 0:
        groupsize = cols
    slabs = W.reshape(units, cols // groupsize, groupsize)
    scale, zero = _find_params(slabs, maxq, sym)
    _, deq = _quantize_col(slabs, scale[..., None], zero[..., None], maxq)
    return deq.reshape(units, cols)


def rtn_quantize(weight_um: torch.Tensor, bits: int = 4,
                 groupsize: int = 128, sym: bool = True) -> torch.Tensor:
    """Round-to-nearest on the same grid, no error feedback: the control
    GPTQ must beat on calibration loss."""
    return _rtn(weight_um.float(), bits, groupsize,
                sym).to(weight_um.dtype)


def gptq_to_int4_params(res: GPTQResult):
    """A symmetric 4-bit, identity-order GPTQ result as the int4 storage of
    ``ops/quant.py``: (kernel_q4 (in/2, out) uint8, kernel_scale (in/G,
    out) fp32).  The symmetric grid's zero point is 8, so code − 8 ∈
    [−8, 7] is the signed nibble and scale·(code − 8) the fake-quant
    weight, bit for bit.  Raises for another grid or order."""
    codes, zero, perm = res.codes, res.zero, res.perm
    if int(codes.max()) > 15:
        raise ValueError("gptq_to_int4_params requires bits=4")
    if not bool((zero == 8).all()):
        raise ValueError("gptq_to_int4_params requires sym grids (zero=8)")
    if not torch.equal(perm.long(), torch.arange(perm.numel(),
                                                 device=perm.device)):
        raise ValueError("gptq_to_int4_params requires act_order=False")
    if codes.shape[1] % 2:
        raise ValueError("in_features must be even")
    q = (codes.to(torch.int32) - 8).t()        # (in, out), values −8..7
    packed = ((q[0::2] & 0xF) | ((q[1::2] & 0xF) << 4)).to(torch.uint8)
    return packed.contiguous(), res.scale.t().contiguous()
