"""Mask selection (port of ``vlm_compression_tpu/ops/masks.py``: the Wanda
and RIA metrics, per-unit unstructured, per-tensor flat threshold, n:m,
transposable n:m and hybrid tiles).

Conventions as there: metrics are unit-major ``(units, in)``; masks are
bool, True = keep.  Ranks come from a stable ascending ``torch.sort``, so
among equal metrics the LOWEST column indices are pruned first — the
tie order of the JAX package's ``_prune_k_smallest_stable``.  The JAX
package's value-space bisection (unsafe for ±inf metrics) is not ported:
the sort is exact for every input.  The sparsity → count conversion runs
in float32, as the JAX package computes it.
"""

from __future__ import annotations

import numpy as np
import torch


def _count(n: int, sparsity: float, rounding: str = "floor") -> int:
    v = np.float32(n) * np.float32(sparsity)
    if rounding == "floor":
        return int(np.floor(v))
    if rounding == "round":
        return int(np.round(v))   # banker's rounding, as jnp.round
    raise ValueError(rounding)


def wanda_metric(weight_um: torch.Tensor, scaler_row: torch.Tensor
                 ) -> torch.Tensor:
    """|W| · sqrt(E‖X_col‖²) — Wanda importance."""
    return weight_um.float().abs() * torch.sqrt(scaler_row)[None, :]


def _prune_k_smallest(metric: torch.Tensor, k: int) -> torch.Tensor:
    """Keep-mask pruning the k smallest along the last axis — the first k
    of a stable ascending sort, so ties prune the lowest index first."""
    order = torch.sort(metric, dim=-1, stable=True).indices
    keep = torch.ones(metric.shape, dtype=torch.bool, device=metric.device)
    return keep.scatter_(-1, order[..., :k], False)


def unstructured_mask(metric: torch.Tensor, sparsity, *,
                      rounding: str = "floor") -> torch.Tensor:
    """Per-unit keep-mask pruning the int(in·sparsity) smallest of each
    row (Wanda/SparseGPT floor; DSnoT round)."""
    return _prune_k_smallest(metric, _count(metric.shape[-1], sparsity,
                                            rounding))


def nm_structured_mask(metric: torch.Tensor, n: int, m: int) -> torch.Tensor:
    """n-of-m structured keep-mask along the input dim (in % m == 0)."""
    units, n_in = metric.shape
    if n_in % m:
        raise ValueError(f"in={n_in} not divisible by m={m}")
    g = metric.reshape(units, n_in // m, m)
    return _prune_k_smallest(g, n).reshape(units, n_in)


def flat_threshold_mask(metric: torch.Tensor, sparsity) -> torch.Tensor:
    """Per-tensor value threshold (ViT Wanda variant): thres =
    sorted_flat[int(numel·s)], keep metric ≥ thres (ties at the threshold
    are kept)."""
    k = _count(metric.numel(), sparsity)
    kc = min(max(k, 0), metric.numel() - 1)
    thres = torch.sort(metric.reshape(-1)).values[kc]
    return metric >= thres


def _stable_rank_ascending(metric: torch.Tensor, dim: int = -1
                           ) -> torch.Tensor:
    """rank[i] = position of element i in a stable ascending sort."""
    order = torch.sort(metric, dim=dim, stable=True).indices
    return torch.sort(order, dim=dim, stable=True).indices


def ria_metric(weight_um: torch.Tensor, scaler_row: torch.Tensor,
               alpha: float = 0.5) -> torch.Tensor:
    """RIA (relative importance and activations): |W| relative to its
    row's and its column's absolute sums, times sqrt(E‖X_col‖²)^α."""
    w = weight_um.float().abs()
    row_sum = w.sum(dim=1, keepdim=True)   # per unit (output row)
    col_sum = w.sum(dim=0, keepdim=True)   # per input column
    ri = w / row_sum.clamp_min(1e-30) + w / col_sum.clamp_min(1e-30)
    return ri * torch.sqrt(scaler_row)[None, :] ** alpha


def transposable_nm_mask(metric: torch.Tensor, n: int, m: int
                         ) -> torch.Tensor:
    """n:m keep-mask valid in both orientations: every m × m tile keeps at
    most m − n entries in each of its rows and columns (n is the count
    PRUNED of every m, as in ``nm_structured_mask``).

    The greedy pass of the JAX package: visit a tile's entries by
    descending metric (a stable sort, so equal metrics go in index order)
    and keep one iff its tile row and tile column still hold fewer than
    m − n kept.  The m² steps run over all tiles at once.  Requires
    units % m == 0 and in % m == 0."""
    units, n_in = metric.shape
    if units % m or n_in % m:
        raise ValueError(f"({units}, {n_in}) not divisible by m={m}")
    limit = m - n
    tiles = (metric.float().reshape(units // m, m, n_in // m, m)
             .permute(0, 2, 1, 3).reshape(-1, m * m))
    order = torch.sort(-tiles, dim=-1, stable=True).indices
    t = tiles.shape[0]
    keep = torch.zeros((t, m * m), dtype=torch.bool, device=metric.device)
    rows = torch.zeros((t, m), dtype=torch.int32, device=metric.device)
    cols = torch.zeros_like(rows)
    for i in range(m * m):
        flat = order[:, i:i + 1]
        r, c = flat // m, flat % m
        ok = (rows.gather(1, r) < limit) & (cols.gather(1, c) < limit)
        keep.scatter_(1, flat, ok)
        rows.scatter_add_(1, r, ok.int())
        cols.scatter_add_(1, c, ok.int())
    return (keep.reshape(units // m, n_in // m, m, m).permute(0, 2, 1, 3)
            .reshape(units, n_in))


def hybrid_tile_mask(metric: torch.Tensor, target_sparsity: float,
                     n: int = 2, m: int = 4, tile: int = 64) -> torch.Tensor:
    """Tile-level hybrid sparsity: the most salient (tile × tile) tiles
    stay dense, the rest take the n:m mask, with the share f of n:m tiles
    solving f·(1 − n/m) = target_sparsity (so the target must be at most
    1 − n/m).  Edge tiles may be smaller (the dims need not divide
    ``tile``); a tile's saliency is the sum of its |metric|, and tiles are
    ranked by a stable ascending sort, so equal saliencies go in index
    order."""
    u, k = metric.shape
    frac_nm = target_sparsity / (1.0 - n / m)
    if frac_nm > 1.0 + 1e-6:
        raise ValueError(
            f"target {target_sparsity} unreachable with {n}:{m} tiles")
    tu, tk = -(-u // tile), -(-k // tile)
    mp = torch.nn.functional.pad(metric, (0, tk * tile - k, 0, tu * tile - u))
    saliency = (mp.reshape(tu, tile, tk, tile).abs().sum(dim=(1, 3))
                .reshape(-1))
    n_sparse = int(round(frac_nm * tu * tk))
    # the least salient tiles take the n:m mask
    tile_sparse = _stable_rank_ascending(saliency, dim=0) < n_sparse
    elem_sparse = (tile_sparse.reshape(tu, tk)
                   .repeat_interleave(tile, dim=0)
                   .repeat_interleave(tile, dim=1)[:u, :k])
    return torch.where(elem_sparse, nm_structured_mask(metric, n, m), True)
