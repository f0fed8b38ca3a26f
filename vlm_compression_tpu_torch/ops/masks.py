"""Mask selection (port of ``vlm_compression_tpu/ops/masks.py``: Wanda
metric, per-unit unstructured, per-tensor flat threshold, n:m).

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
