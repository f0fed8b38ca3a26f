"""SparseLinear — the one linear every tower is built from (port of
``vlm_compression_tpu/models/layers.py``), plus the small shared layers.

Parameters keep the JAX layout and names: ``kernel`` is (in, out), ``bias``
(out,), and the optional bool ``mask`` buffer is (in, out), True = keep.
The forward mode is an argument, as in the JAX package:

  dense   y = x · W          (teacher path: the mask is bypassed)
  masked  y = x · (W ⊙ M)    (pruned model; runs the masked-matmul kernel
                              on the card; without a mask it is x · W)

``sparse_lora`` and ``lora`` arrive with the retraining slice, as do the
int8/int4 kernels and bit-packed masks.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vlm_compression_tpu_torch.ops.masked_linear import masked_matmul

DENSE = "dense"
MASKED = "masked"
SPARSE_LORA = "sparse_lora"
LORA = "lora"
_MODES = (DENSE, MASKED, SPARSE_LORA, LORA)


class SparseLinear(nn.Module):
    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 param_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.kernel = nn.Parameter(torch.empty(
            (in_features, features), dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)
        self.register_buffer("mask", None)

    def forward(self, x: torch.Tensor, mode: str = MASKED) -> torch.Tensor:
        if mode not in _MODES:
            raise ValueError(f"mode {mode!r} not in {_MODES}")
        if mode in (SPARSE_LORA, LORA):
            raise NotImplementedError(
                f"mode {mode!r} (SparseLoRA) arrives with the retraining "
                "slice of the port")
        # compute dtype follows the input, as in the JAX package
        k = self.kernel.to(x.dtype)
        if mode == DENSE or self.mask is None:
            y = x @ k
        else:
            y = masked_matmul(x, k, self.mask)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics with the fast
    variance E[x²] − E[x]² (clipped at 0); output float32."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


class Embed(nn.Module):
    """Flax ``nn.Embed``: a gather from ``embedding`` (vocab, features)."""

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty((num, features), dtype=dtype,
                                                  device=device))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids]


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def set_mask(linear: SparseLinear, mask: Optional[torch.Tensor]) -> None:
    """Attach (or drop, with None) the keep-mask of one linear."""
    if mask is not None:
        if tuple(mask.shape) != tuple(linear.kernel.shape):
            raise ValueError(f"mask {tuple(mask.shape)} vs kernel "
                             f"{tuple(linear.kernel.shape)}")
        mask = mask.to(device=linear.kernel.device, dtype=torch.bool)
    linear.mask = mask
