"""AWQ: activation-aware weight scaling for low-bit quantization (port of
``vlm_compression_tpu/ops/awq.py``).

Salient input channels (large activations) suffer most from weight
quantization, so each input channel is scaled before quantizing,
``W' = W·diag(s)``, with the inputs compensated, ``x' = x/s``.  The scale
is searched per linear: ``s_j = sx_j^α / wmax_j^(1−α)`` (sx the RMS input
magnitude from the calibration ``scaler_row``, wmax the channel's weight
absmax), α ∈ [0, 1] on 21 points plus the identity (plain RTN), chosen by
the OBS loss ``Σ_u (W−Ŵ) H (W−Ŵ)ᵀ`` on the calibration Hessian in fp32.

``awq_rtn_quantize`` scales, rounds to nearest and unscales; ``apply_awq``
gives the scaled problem for ``gptq_quantize`` (H becomes
``diag(1/s)·H·diag(1/s)``), then ``unscale_weight``.  ``awq_int4_matmul``
serves int4 weights kept in scaled space.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vlm_compression_tpu_torch.ops.gptq import _rtn
from vlm_compression_tpu_torch.ops.stats import pin_fp32


class AWQScales(NamedTuple):
    s: torch.Tensor        # (in,) per-channel scales (scaled space = W·s)
    alpha: torch.Tensor    # () chosen exponent, −1 for the identity
    losses: torch.Tensor   # (n_alphas + 1,) OBS loss per candidate


def _rtn_grouped(W: torch.Tensor, bits: int, groupsize: int, sym: bool
                 ) -> torch.Tensor:
    """RTN fake-quant of (units, cols) fp32 on grouped grids."""
    return _rtn(W, bits, groupsize, sym)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root (through float64), as XLA's;
    torch's vectorized CPU one can miss by an ulp."""
    return torch.sqrt(x.double()).float()


def _alphas(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` as XLA forms it in float32: iota times
    the float32 reciprocal of n − 1, the last point 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.tensor(1.0 / (n - 1), dtype=torch.float32, device=device)
    a = torch.arange(n - 1, dtype=torch.float32, device=device) * step
    return torch.cat([a, torch.ones(1, device=device)])


def _candidates(W: torch.Tensor, scaler_row: torch.Tensor, n_alphas: int):
    """(alphas (n_alphas,), the candidate scales (n_alphas + 1, in): one
    per α, then the identity)."""
    sx = _sqrt(torch.clamp(scaler_row.float(), min=1e-12))
    wmax = torch.clamp(W.abs().amax(dim=0), min=1e-12)
    alphas = _alphas(n_alphas, W.device)
    # powers in float64, rounded once: XLA's float32 pow is close to
    # correctly rounded, torch's is not
    cand = (torch.pow(sx[None, :].double(), alphas[:, None].double())
            .float()
            / torch.pow(wmax[None, :].double(),
                        (1.0 - alphas[:, None]).double()).float())
    cand = cand / _sqrt(cand.amax(dim=1, keepdim=True)
                        * cand.amin(dim=1, keepdim=True))
    cand = torch.clamp(cand, 1e-4, 1e4)
    return alphas, torch.cat([cand, torch.ones((1, W.shape[1]),
                                               device=W.device)])


@torch.no_grad()
def awq_search(weight_um: torch.Tensor, scaler_row: torch.Tensor,
               hessian: torch.Tensor, bits: int = 4, groupsize: int = 128,
               sym: bool = True, n_alphas: int = 21) -> AWQScales:
    """Grid-search α on the OBS objective.  α = 0 gives s ∝ 1/wmax; the
    all-ones candidate (plain RTN) is added, so AWQ never does worse than
    no scaling."""
    if weight_um.is_cuda:
        pin_fp32()
    W = weight_um.float()
    H = hessian.float()
    alphas, cand = _candidates(W, scaler_row, n_alphas)
    losses = torch.empty(cand.shape[0], device=W.device)
    for a, s in enumerate(cand):      # one candidate at a time bounds memory
        D = W - _rtn_grouped(W * s[None, :], bits, groupsize,
                             sym) / s[None, :]
        losses[a] = (torch.matmul(D, H) * D).sum()
    best = torch.argmin(losses)
    alpha = torch.where(best < n_alphas,
                        alphas[torch.clamp(best, max=n_alphas - 1)],
                        torch.full((), -1.0, device=W.device))
    return AWQScales(s=cand[best], alpha=alpha, losses=losses)


def apply_awq(weight_um: torch.Tensor, hessian: torch.Tensor,
              s: torch.Tensor):
    """(W·diag(s), diag(1/s)·H·diag(1/s)): the scaled problem, whose inputs
    are x/s; quantize it, then ``unscale_weight``."""
    W = weight_um.float() * s[None, :]
    H = hessian.float() / (s[:, None] * s[None, :])
    return W, H


def unscale_weight(weight_scaled: torch.Tensor, s: torch.Tensor):
    return weight_scaled / s[None, :]


def awq_rtn_quantize(weight_um: torch.Tensor, s: torch.Tensor,
                     bits: int = 4, groupsize: int = 128,
                     sym: bool = True) -> torch.Tensor:
    """Classic AWQ: fake-quant weights in original space."""
    W = weight_um.float()
    deq = _rtn_grouped(W * s[None, :], bits, groupsize, sym) / s[None, :]
    return deq.to(weight_um.dtype)


def awq_int4_matmul(x: torch.Tensor, packed: torch.Tensor,
                    scale: torch.Tensor, s: torch.Tensor,
                    mask=None) -> torch.Tensor:
    """y = (x/s) @ dequant(packed, scale): int4 weights stored in scaled
    space, the activations compensated on their way in."""
    from vlm_compression_tpu_torch.ops.quant import int4_matmul

    return int4_matmul(x / s.to(x.dtype), packed, scale, mask=mask)
