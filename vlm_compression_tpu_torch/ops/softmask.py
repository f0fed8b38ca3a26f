"""Annealed Hessian-guided soft-mask n:m pruning (port of
``vlm_compression_tpu/ops/softmask.py``).

The per-group keep-top choice is relaxed to a differentiable soft mask;
Adam on the mask logits minimises the layer's OBS reconstruction error

    E(M) = Σ_j d_jᵀ H d_j,   d_j = w_j ⊙ (m_j − 1)

under that relaxation while a geometric temperature schedule anneals it
toward hard, with the calibration Hessians ``(2/N) XᵀX``.  The returned
mask is the hard mask of least true error over the whole trajectory, the
starting (Wanda) mask included, so the method never does worse than its
start.  Groups are ``m`` consecutive input columns, and ``n`` is the count
PRUNED of every ``m`` (the convention of ``ops/masks.nm_structured_mask``).

Plain torch in float32: the JAX package has no Pallas kernel here.  The
batched form runs G equal-shape linears (a block's q/k/v/o) over a stacked
leading axis with ``torch.bmm``; the one-linear form is that with G = 1.
The whole trajectory stays on the device: no host sync a step.
"""

from __future__ import annotations

from typing import Optional

import torch


def soft_topn(logits: torch.Tensor, n: int, tau) -> torch.Tensor:
    """Differentiable relaxation of keep-top-n over the last axis: n rounds
    of temperature-τ softmax, each adding one unit of mass with what was
    already taken soft-excluded by a log(1 − taken) penalty inside the
    temperature.  Sums to n over the last axis."""
    taken = torch.zeros_like(logits)
    for _ in range(n):
        avail = (1.0 - taken).clamp(1e-9, 1.0)
        taken = taken + torch.softmax((logits + torch.log(avail)) / tau,
                                      dim=-1)
    return taken


def hard_topn(logits: torch.Tensor, n: int) -> torch.Tensor:
    """Exact keep-top-n bool mask over the last axis (stable ties: among
    equal logits the lower index is kept).

    An entry's rank is the count of greater entries in its group plus the
    count of equal ones before it: its position in a stable descending
    sort (the JAX package's double argsort), from m × m comparisons, which
    on the card cost a fifteenth of the two sorts."""
    idx = torch.arange(logits.shape[-1], device=logits.device)
    mine, other = logits[..., :, None], logits[..., None, :]
    rank = (other > mine).sum(dim=-1) + (
        (other == mine) & (idx[None, :] < idx[:, None])).sum(dim=-1)
    return rank < n


def _obs_error(weight_um: torch.Tensor, hessian: torch.Tensor,
               mask_um: torch.Tensor) -> torch.Tensor:
    """Σ_j d_jᵀ H d_j with d = W ⊙ (M − 1), over (G, units, in) stacks:
    one error a linear, (G,)."""
    d = (weight_um * (mask_um - 1.0)).float()
    return (d * torch.bmm(d, hessian)).sum(dim=(1, 2))


def softmask_nm_prune_batched(weights_um: torch.Tensor,
                              hessians: torch.Tensor, n: int, m: int,
                              init_metrics: Optional[torch.Tensor] = None,
                              steps: int = 48, lr: float = 0.1,
                              tau_start: float = 2.0, tau_end: float = 0.05):
    """Train n:m keep-masks for G equal-shape linears at once.

    weights_um   : (G, units, in), the transposed kernels
    hessians     : (G, in, in) float32 ``(2/N) XᵀX``
    init_metrics : (G, units, in) saliency for the logits' start (default
                   |W|·sqrt(diag H))

    Returns (keep (G, units, in) bool, err_best (G,), err_init (G,))."""
    g_, units, n_in = weights_um.shape
    if n_in % m:
        raise ValueError(f"in={n_in} not divisible by m={m}")
    n_keep, groups = m - n, n_in // m
    w = weights_um.float()
    h = hessians.float()
    if init_metrics is None:
        diag = torch.diagonal(h, dim1=1, dim2=2).clamp_min(1e-12)
        init_metrics = w.abs() * torch.sqrt(diag)[:, None, :]
    met = init_metrics.float().reshape(g_, units, groups, m)
    # scale-free logits: normalised per group, then log
    met = met / (met.mean(dim=-1, keepdim=True) + 1e-12)
    logits = torch.log(met + 1e-6)
    taus = tau_start * (tau_end / tau_start) ** (
        torch.arange(steps, dtype=torch.float32, device=w.device)
        / max(steps - 1, 1))

    def hard_err(lg):
        mask = hard_topn(lg, n_keep).reshape(g_, units, n_in)
        return mask, _obs_error(w, h, mask.float())

    best_mask, best_err = hard_err(logits)
    err_init = best_err.clone()
    mu = torch.zeros_like(logits)
    nu = torch.zeros_like(logits)
    for t in range(steps):
        with torch.enable_grad():
            lg = logits.detach().requires_grad_(True)
            soft = soft_topn(lg, n_keep, taus[t]).reshape(g_, units, n_in)
            (gr,) = torch.autograd.grad(_obs_error(w, h, soft).sum(), lg)
        with torch.no_grad():
            # Adam with bias correction, lr on the log-scale logits
            mu = 0.9 * mu + 0.1 * gr
            nu = 0.999 * nu + 0.001 * gr * gr
            mh = mu / (1.0 - 0.9 ** (t + 1.0))
            nh = nu / (1.0 - 0.999 ** (t + 1.0))
            logits = logits - lr * mh / (torch.sqrt(nh) + 1e-8)
            # the best HARD mask along the trajectory: the soft objective
            # at warm τ is a biased proxy of the true error
            mask, err = hard_err(logits)
            better = err < best_err
            best_mask = torch.where(better[:, None, None], mask, best_mask)
            best_err = torch.where(better, err, best_err)
    return best_mask, best_err, err_init


def softmask_nm_prune(weight_um: torch.Tensor, hessian: torch.Tensor,
                      n: int, m: int,
                      init_metric: Optional[torch.Tensor] = None,
                      steps: int = 48, lr: float = 0.1,
                      tau_start: float = 2.0, tau_end: float = 0.05):
    """One linear: (keep (units, in) bool, err_best, err_init), the batched
    form at G = 1."""
    keep, err_best, err_init = softmask_nm_prune_batched(
        weight_um[None], hessian[None], n, m,
        None if init_metric is None else init_metric[None],
        steps=steps, lr=lr, tau_start=tau_start, tau_end=tau_end)
    return keep[0], err_best[0], err_init[0]
