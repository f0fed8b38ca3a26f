"""SparseGPT: OBS pruning with weight update (port of
``vlm_compression_tpu/ops/sparsegpt.py``, its default route).

Per linear, unit-major W (units, in) and the calibration Hessian H (in, in):

  * dead columns (diag H = 0): H gets 1 on the diagonal there, W zeros;
  * ±inf entries of H clamp to its 99.9 % / 0.1 % quantiles;
  * the upper Cholesky factor of H⁻¹ through the exchange-matrix identity
    chol_upper(H⁻¹) = J·chol_lower(J·H·J)⁻¹·J: one Cholesky of the flipped
    H and one triangular inverse, retried with damp·I added (damp =
    0.01·mean diag H) until the factorization succeeds and the inverse is
    finite, at most 32 times (the JAX package retries on a NaN factor
    only);
  * the blocked sweep over 128-column blocks.  Unstructured: each block's
    mask is fixed up front by the threshold ``tmp <= sorted(tmp)[⌊size·s⌋]``
    (ties pruned) on tmp = W²/diag(H⁻¹)², and the serial column recursion
    is solved in closed form, a blocked forward substitution in panels of
    16 columns.  n:m: the per-column recursion, each group of m columns
    choosing its n lowest-metric columns by a stable argsort.  After each
    block, W[:, i2:] -= Err·H⁻¹[i1:i2, i2:].

Split on its units over a ``model`` group (``unit_group``; each rank its
block of the units, every rank the whole Hessian), the unstructured
block threshold stays the whole block's: tmp is all-gathered over the
units for the k-th value, and each rank keeps its units' part of the
mask.  Everything else is row-parallel as it stands.

``damped`` counts the matrices that got damping, by why their first
factorization was not used: ``"factorization"`` (it failed; the JAX
package damps there too) and ``"inverse"`` (it succeeded, but its inverse
overflowed; the JAX package goes on with NaN weights there).

Everything runs in fp32 with TF32 off; the linear algebra stays with
torch.linalg (cuSOLVER on the card), as the JAX package leaves it to XLA.
``sparsegpt_prune_group`` prunes equal-shape linears of a block together
with a leading batch dimension (T5's q/k/v/o share a shape): each panel
step is one launch for the whole group, which divides the launches of the
serial recursion — the sweep's cost in eager PyTorch — by the group size.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from vlm_compression_tpu_torch.ops.stats import (
    CalibStats,
    finalize_hessian,
    pin_fp32,
)

PANEL = 16        # columns per panel of the unstructured substitution

damped = {"factorization": 0, "inverse": 0}


class SparseGPTResult(NamedTuple):
    weight: torch.Tensor      # (units, in) updated weights, pruned entries 0
    keep_mask: torch.Tensor   # (units, in) bool, True = keep
    losses: torch.Tensor      # (units,) accumulated OBS losses
    importance: torch.Tensor  # () mean |W² / diag(H⁻¹)²|


def _bisect_quantile(h: torch.Tensor, q: float, iters: int = 45
                     ) -> torch.Tensor:
    """The JAX package's q-quantile: value-space bisection over
    count(h ≤ t), ±inf ranking above / below every finite value."""
    finite = torch.isfinite(h)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=h.device)
    lo = torch.where(finite, h, big).min()
    hi = torch.where(finite, h, -big).max()
    k = round(q * h.numel())
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        enough = (h <= mid).sum() >= k
        lo, hi = torch.where(enough, lo, mid), torch.where(enough, mid, hi)
    return hi


def _clamp_infs(h: torch.Tensor) -> torch.Tensor:
    """Clamp ±inf entries to the 99.9 % / 0.1 % quantiles."""
    pos = torch.isinf(h) & (h > 0)
    if bool(pos.any()):
        h = torch.where(pos, _bisect_quantile(h, 0.999), h)
    neg = torch.isinf(h) & (h < 0)
    if bool(neg.any()):
        h = torch.where(neg, _bisect_quantile(h, 0.001), h)
    return h


def _damped(h, damp, max_tries, finish):
    """``finish`` of the lower Cholesky factor of each (…, n, n) matrix; a
    matrix whose factorization fails, or whose result is not finite, gets
    damp·I added (its own damp, ``damp`` (…,)) and is tried again, at most
    ``max_tries`` times."""
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    for attempt in range(max_tries + 1):
        chol, info = torch.linalg.cholesky_ex(h)
        out = finish(chol)
        failed = info != 0
        bad = failed | ~torch.isfinite(out).flatten(-2).all(-1)
        if attempt == 0:
            damped["factorization"] += int(failed.sum())
            damped["inverse"] += int((bad & ~failed).sum())
        if attempt == max_tries or not bool(bad.any()):
            return out
        h = h + torch.where(bad, damp, 0.0)[..., None, None] * eye


def damped_cholesky(h: torch.Tensor, damp: torch.Tensor,
                    max_tries: int = 32) -> torch.Tensor:
    """Lower Cholesky factor of each (…, n, n) matrix, adding damp·I until
    the factorization succeeds (``cholesky_ex`` reports a failure where the
    JAX package tests the factor for NaN) and the factor is finite."""
    return _damped(h, damp, max_tries, lambda chol: chol)


def _upper_factor_of_inverse(h: torch.Tensor, percdamp: float
                             ) -> torch.Tensor:
    """chol_upper(H⁻¹) = J·chol_lower(J·H·J)⁻¹·J, batched over (…, n, n).
    The damped retry also covers a triangular inverse that overflows: the
    first, undamped factorization of an ill-conditioned H can succeed with
    a factor whose inverse is not finite (a random-init XL ViT block's qkv
    Hessian did, on the H100), which would fill the sweep with NaN — the
    JAX package, which retries only on a NaN factor, returns NaN weights
    there (tests/test_torch_sparsegpt.py)."""
    damp = percdamp * torch.diagonal(h, dim1=-2, dim2=-1).mean(-1)
    eye = torch.eye(h.shape[-1], dtype=h.dtype, device=h.device)
    minv = _damped(h.flip(-2, -1), damp, 32,
                   lambda m: torch.linalg.solve_triangular(
                       m, eye.expand_as(m), upper=False))
    return minv.flip(-2, -1)


def _block_threshold_mask(w1: torch.Tensor, d1: torch.Tensor,
                          sparsity: float, unit_group=None) -> torch.Tensor:
    """Unstructured block mask (True = prune): tmp ≤ the ⌊size·s⌋-th
    smallest tmp of the block (0-based, ties pruned), per member; the
    whole block's over ``unit_group``'s units."""
    from vlm_compression_tpu_torch.parallel.collectives import all_gather_dim

    tmp = w1 * w1 / (d1[:, None, :] ** 2)
    whole = all_gather_dim(tmp, unit_group, 1) if unit_group is not None \
        else tmp
    size = whole[0].numel()
    # the JAX package forms size·s in float32
    k = int(np.floor(np.float32(size) * np.float32(sparsity)))
    k = min(max(k, 0), size - 1)
    thresh = torch.kthvalue(whole.reshape(whole.shape[0], -1), k + 1,
                            dim=1)[0]
    return tmp <= thresh[:, None, None]


def _solve_block_unstructured(w1, hinv1, d1, prune1):
    """Closed form of the block's serial recursion when its mask is fixed:
    per row, x_i = p_i·(w_i − Σ_{k<i} x_k·U[k,i]) / d_i (U the strict upper
    triangle of the block's H⁻¹ factor), by forward substitution in panels
    of PANEL columns: one batched product folds the solved columns into a
    panel, then the panel's own recursion runs column by column.
    Returns the errors x (…, units, B)."""
    g, units, b = w1.shape
    strict_u = torch.triu(hinv1, diagonal=1)
    pr = prune1.to(w1.dtype)
    wp = w1 * pr
    x = torch.zeros_like(w1)
    s = PANEL if (b % PANEL == 0 and b > PANEL) else b
    for i in range(0, b, s):
        prp = pr[..., i:i + s]
        acc = wp[..., i:i + s] - prp * torch.matmul(x, strict_u[..., i:i + s])
        # pu[:, :, c, j] = prp[:, :, j]·U[i+c, i+j] (j > c): the in-panel
        # coupling of column c into the later columns, masked per row
        upp = torch.triu(hinv1[:, i:i + s, i:i + s], diagonal=1)
        pu = prp[:, :, None, :] * upp[:, None, :, :]
        dp = d1[:, None, i:i + s]
        xp = x[..., i:i + s]
        for c in range(s):   # two launches a column
            torch.div(acc[..., c], dp[..., c], out=xp[..., c])
            if c + 1 < s:
                acc.addcmul_(xp[..., c:c + 1], pu[:, :, c, :], value=-1.0)
    return x


def _sweep_block_nm(w1, hinv1, d1, prune_n, prune_m):
    """The n:m block sweep, column by column (the reference recursion).
    Returns (Q1, Err1, L1, prune1)."""
    g, units, b = w1.shape
    w1 = w1.clone()
    q1 = torch.zeros_like(w1)
    err1 = torch.zeros_like(w1)
    l1 = torch.zeros_like(w1)
    prune1 = torch.zeros_like(w1, dtype=torch.bool)
    for i in range(b):
        if i % prune_m == 0:
            grp = w1[..., i:i + prune_m]
            dg = d1[:, None, i:i + prune_m]
            met = grp * grp / dg ** 2
            order = torch.argsort(met, dim=-1, stable=True)
            rank = torch.argsort(order, dim=-1, stable=True)
            prune1[..., i:i + prune_m] = rank < prune_n
        w = w1[..., i]
        d = hinv1[:, None, i, i]
        q = torch.where(prune1[..., i], 0.0, w)
        q1[..., i] = q
        l1[..., i] = (w - q) ** 2 / (d * d)
        err = (w - q) / d
        w1[..., i:] -= err[..., None] * hinv1[:, None, i, i:]
        err1[..., i] = err
    return q1, err1, l1, prune1


@torch.no_grad()
def sparsegpt_prune_batched(weights_um: torch.Tensor, hessians: torch.Tensor,
                            sparsity: float, prune_n: int = 0,
                            prune_m: int = 0, blocksize: int = 128,
                            percdamp: float = 0.01, unit_group=None
                            ) -> SparseGPTResult:
    """Prune + OBS-update G linears of one shape: weights (G, units, in),
    Hessians (G, in, in).  Returns a SparseGPTResult with a leading G.
    ``unit_group``: the weights are this rank's units of a split."""
    if weights_um.is_cuda:
        pin_fp32()
    W = weights_um.float().clone()
    H = hessians.float().clone()
    g, units, cols = W.shape
    out_dtype = weights_um.dtype

    # dead columns
    dead = torch.diagonal(H, dim1=-2, dim2=-1) == 0
    H = H + torch.diag_embed(dead.to(H.dtype))
    W.masked_fill_(dead[:, None, :], 0.0)

    H = torch.stack([_clamp_infs(h) for h in H])
    Hinv = _upper_factor_of_inverse(H, percdamp)
    del H
    hinv_diag = torch.diagonal(Hinv, dim1=-2, dim2=-1)
    importance = (W * W / hinv_diag[:, None, :] ** 2).abs().mean(dim=(1, 2))

    b = blocksize if cols % blocksize == 0 else cols
    losses = torch.zeros((g, units), dtype=torch.float32, device=W.device)
    keep = torch.empty((g, units, cols), dtype=torch.bool, device=W.device)
    for i1 in range(0, cols, b):
        i2 = i1 + b
        w1 = W[..., i1:i2]
        hinv1 = Hinv[:, i1:i2, i1:i2]
        d1 = torch.diagonal(hinv1, dim1=-2, dim2=-1)
        if prune_n == 0:
            prune1 = _block_threshold_mask(w1, d1, sparsity, unit_group)
            err1 = _solve_block_unstructured(w1, hinv1, d1, prune1)
            q1 = torch.where(prune1, 0.0, w1 - torch.matmul(
                err1, torch.triu(hinv1, diagonal=1)))
            l1 = err1 * err1
        else:
            q1, err1, l1, prune1 = _sweep_block_nm(w1, hinv1, d1, prune_n,
                                                   prune_m)
        W[..., i1:i2] = q1
        losses += l1.sum(-1) / 2.0
        keep[..., i1:i2] = ~prune1
        if i2 < cols:
            W[..., i2:] -= torch.matmul(err1, Hinv[:, i1:i2, i2:])
    return SparseGPTResult(weight=W.to(out_dtype), keep_mask=keep,
                           losses=losses, importance=importance)


def sparsegpt_prune(weight_um: torch.Tensor, hessian: torch.Tensor,
                    sparsity: float, prune_n: int = 0, prune_m: int = 0,
                    blocksize: int = 128, percdamp: float = 0.01
                    ) -> SparseGPTResult:
    """Prune + OBS-update one linear: weight (units, in) in any float
    dtype (fp32 inside), hessian (in, in) = (2/n)·Σ XᵀX."""
    res = sparsegpt_prune_batched(weight_um[None], hessian[None], sparsity,
                                  prune_n, prune_m, blocksize, percdamp)
    return SparseGPTResult(*(t[0] for t in res))


def sparsegpt_prune_group(kernels_io: Sequence[torch.Tensor],
                          stats: Sequence[CalibStats], sparsity: float,
                          prune_n: int = 0, prune_m: int = 0,
                          blocksize: int = 128, percdamp: float = 0.01,
                          unit_group=None):
    """One batched solve for an equal-shape group of linears: kernels in
    (in, units) layout and their calibration stats.  Returns a tuple of
    (keep_mask (in, units), new kernel (in, units), importance) per
    member, contiguous in the kernels' layout."""
    ws = torch.stack([k.t() for k in kernels_io])
    hs = torch.stack([finalize_hessian(s) for s in stats])
    res = sparsegpt_prune_batched(ws, hs, sparsity, prune_n, prune_m,
                                  blocksize, percdamp, unit_group)
    del ws, hs
    return tuple((res.keep_mask[i].t().contiguous(),
                  res.weight[i].t().contiguous(), res.importance[i])
                 for i in range(len(kernels_io)))
