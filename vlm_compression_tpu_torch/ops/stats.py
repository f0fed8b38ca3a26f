"""Calibration statistics as fold functions (port of
``vlm_compression_tpu/ops/stats.py``).

Per input column, all fp32:
  scaler_row      = Σ_tokens x² / n_samples          (Wanda ‖X‖₂² statistic)
  sum_metric_row  = Σ_tokens x  / n_samples          (DSnoT signed metric)
  mean, var       = token-weighted mean of per-update means/variances
  hessian         = (2 / n_samples) Σ XᵀX            (SparseGPT)

The fold includes every token it is given, pads included, as the
reference's hooks do; a ``token_mask`` excludes positions only when a
caller passes one.  Folds run in full fp32: TF32 is switched off for the
matmul and cuDNN before a fold on the card (a reduced-precision Hessian
fold flipped SparseGPT mask bits in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class CalibStats:
    nsamples: int                 # calibration samples folded in
    ntokens: torch.Tensor         # () int64 — total tokens folded in
    ssq: torch.Tensor             # (in,) Σ x²  over all tokens
    ssum: torch.Tensor            # (in,) Σ x   over all tokens
    var_acc: torch.Tensor         # (in,) Σ_updates var_u · tokens_u
    mean_acc: torch.Tensor        # (in,) Σ_updates mean_u · tokens_u
    hessian: Optional[torch.Tensor] = None  # (in, in) Σ XᵀX

    @property
    def scaler_row(self) -> torch.Tensor:
        return self.ssq / float(max(self.nsamples, 1))

    @property
    def sum_metric_row(self) -> torch.Tensor:
        return self.ssum / float(max(self.nsamples, 1))

    @property
    def mean(self) -> torch.Tensor:
        return self.mean_acc / self.ntokens.clamp(min=1).float()

    @property
    def var(self) -> torch.Tensor:
        return self.var_acc / self.ntokens.clamp(min=1).float()


def init_calib_stats(in_features: int, with_hessian: bool = False,
                     device=None) -> CalibStats:
    z = torch.zeros((in_features,), dtype=torch.float32, device=device)
    h = (torch.zeros((in_features, in_features), dtype=torch.float32,
                     device=device) if with_hessian else None)
    return CalibStats(
        nsamples=0,
        ntokens=torch.zeros((), dtype=torch.int64, device=device),
        ssq=z, ssum=z.clone(), var_acc=z.clone(), mean_acc=z.clone(),
        hessian=h)


def pin_fp32() -> None:
    """Full-precision fp32 products on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def update_calib_stats(stats: CalibStats, x: torch.Tensor,
                       token_mask: Optional[torch.Tensor] = None
                       ) -> CalibStats:
    """Fold one batch of activations (batch, tokens, in) into the stats;
    ``token_mask`` (batch, tokens) 1/0 optionally excludes positions."""
    if x.is_cuda:
        pin_fp32()
    x = x.float()
    if x.ndim == 2:
        x = x[None]
    b, t, d = x.shape
    if token_mask is not None:
        m = token_mask.float()[..., None]
        x = x * m
        n_tok = token_mask.sum().to(torch.int64)
        n_tok_f = n_tok.clamp(min=1).float()
    else:
        n_tok = torch.tensor(b * t, dtype=torch.int64, device=x.device)
        n_tok_f = float(b * t)

    flat = x.reshape(b * t, d)
    ssq_u = torch.sum(flat * flat, dim=0)
    ssum_u = torch.sum(flat, dim=0)
    mean_u = ssum_u / n_tok_f
    var_u = ssq_u / n_tok_f - mean_u * mean_u
    hessian = None
    if stats.hessian is not None:
        hessian = stats.hessian + flat.T @ flat
    return CalibStats(
        nsamples=stats.nsamples + b,
        ntokens=stats.ntokens + n_tok,
        ssq=stats.ssq + ssq_u,
        ssum=stats.ssum + ssum_u,
        var_acc=stats.var_acc + var_u * n_tok_f,
        mean_acc=stats.mean_acc + mean_u * n_tok_f,
        hessian=hessian)


def all_reduce_calib_stats(stats: CalibStats, group) -> CalibStats:
    """Every rank's sums added over ``group`` (the data ranks of a sharded
    calibration; ``stats`` unchanged where the group is one rank): the
    sample and token counts, Σx², Σx, the moment sums and the Hessian.
    The moment sums add per rank's update, as they add per update."""
    from vlm_compression_tpu_torch.parallel.collectives import (
        all_reduce_,
        group_size,
    )

    if group_size(group) == 1:
        return stats
    vecs = torch.stack([stats.ssq, stats.ssum, stats.var_acc,
                        stats.mean_acc])
    counts = torch.stack([torch.tensor(float(stats.nsamples),
                                       device=vecs.device),
                          stats.ntokens.to(vecs.device).double().float()])
    flat = torch.cat([vecs.reshape(-1), counts])
    all_reduce_(flat, group)
    n = stats.ssq.numel()
    vecs = flat[:4 * n].view(4, n)
    hessian = stats.hessian
    if hessian is not None:
        hessian = all_reduce_(hessian.clone(), group)
    return CalibStats(
        nsamples=int(round(float(flat[4 * n]))),
        ntokens=flat[4 * n + 1].round().to(torch.int64),
        ssq=vecs[0].clone(), ssum=vecs[1].clone(), var_acc=vecs[2].clone(),
        mean_acc=vecs[3].clone(), hessian=hessian)


def finalize_hessian(stats: CalibStats) -> torch.Tensor:
    """H = (2/n_samples) Σ XᵀX."""
    if stats.hessian is None:
        raise ValueError("stats were initialised without a Hessian")
    return stats.hessian * (2.0 / float(max(stats.nsamples, 1)))
