"""Attention core shared by every tower: plain version + flash kernel.

Counterpart of ``vlm_compression_tpu/ops/attention.py`` (forward only).
Semantics, identical in both versions:

  s   = (q · kᵀ) * scale + Σ bias_i          (fp32)
  s   = NEG_INF where right-aligned causal masking hides key j from query i
        (j > i + m − n)
  p   = softmax(s, axis=-1)                   (fp32)
  out = p.astype(v.dtype) · v

Layout: q (b, n, h, d), k/v (b, m, h, d); biases are additive fp32 arrays
broadcastable to (b, h, n, m).  ``attention_core`` runs ``mha_reference``
on CPU tensors and the hand-written kernel ``csrc/flash_attention.cu`` on
CUDA tensors (launch or raise, no fallback — decode steps included).
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from vlm_compression_tpu_torch.ops import _cuda

NEG_INF = -1e9  # matches the towers' additive-mask constant

launches = 0


def _as_4d(bias: torch.Tensor) -> torch.Tensor:
    return bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape)) \
        if bias.ndim < 4 else bias


def mha_reference(q, k, v, biases: Sequence[torch.Tensor] = (),
                  scale: float = 1.0, causal: bool = False) -> torch.Tensor:
    """q (b,n,h,d), k/v (b,m,h,d), biases broadcastable to (b,h,n,m)."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    for bias in biases:
        s = s + bias.float()
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        vis = (torch.arange(m, device=s.device)[None, :]
               <= torch.arange(n, device=s.device)[:, None] + (m - n))
        s = torch.where(vis[None, None], s,
                        torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", p, v)


def attention_core(q, k, v, biases: Sequence[Optional[torch.Tensor]] = (),
                   scale: float = 1.0, causal: bool = False) -> torch.Tensor:
    """Shared attention core for every tower (None biases are dropped)."""
    biases = [_as_4d(x) for x in biases if x is not None]
    if q.device.type == "cpu":
        return mha_reference(q, k, v, biases, scale, causal)
    return flash_attention(q, k, v, biases, scale, causal)[0]


_DTYPES = (torch.bfloat16, torch.float32)
_STRIDES = ctypes.c_longlong * 17


def _check_inputs(q, k, v, biases):
    """Raise the specific error for q/k/v the kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("flash_attention: q, k, v must all be bfloat16 or "
                        "all float32")
    if not 0 < d <= 128:
        raise ValueError(f"flash_attention: head dim {d} not in 1..128")
    if m == 0:
        raise ValueError("flash_attention: no keys")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all inputs must share a device")
    if len(biases) > 2:
        raise ValueError("flash_attention: at most two additive biases")
    raise ValueError("flash_attention: q/k/v need a contiguous last dim")


def _check_bias(bias, device, full):
    if bias.dtype != torch.float32:
        raise TypeError(f"flash_attention: biases must be float32, got "
                        f"{bias.dtype}")
    if bias.device != device:
        raise ValueError("flash_attention: all inputs must share a device")
    raise ValueError(f"flash_attention: bias {tuple(bias.shape)} does not "
                     f"broadcast to {full}")


def flash_attention(q, k, v, biases: Sequence[torch.Tensor] = (),
                    scale: float = 1.0, causal: bool = False):
    """Launch the flash kernel on CUDA tensors → (out (b,n,h,d) in q's
    dtype, lse (b,h,n) float32)."""
    global launches
    dev = q.device
    b, n, h, d = q.shape
    m = k.shape[1]
    if not (dev.type == "cuda" and k.shape == (b, m, h, d)
            and v.shape == k.shape and q.dtype == k.dtype == v.dtype
            and q.dtype in _DTYPES and 0 < d <= 128 and m > 0
            and k.device == dev and v.device == dev and q.stride(3) == 1
            and k.stride(3) == 1 and v.stride(3) == 1 and len(biases) <= 2):
        _check_inputs(q, k, v, biases)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    ptrs = [None, None]
    full = (b, h, n, m)
    for i, bias in enumerate(biases):
        bias = _as_4d(bias)
        shape = bias.shape
        if not (bias.dtype == torch.float32 and bias.device == dev
                and all(s in (1, f) for s, f in zip(shape, full))):
            _check_bias(bias, dev, full)
        # stride 0 on broadcast axes: the kernel reads the small array
        st = bias.stride()
        strides += [st[ax] if shape[ax] > 1 else 0 for ax in range(4)]
        ptrs[i] = bias.data_ptr()
    strides += [0] * (17 - len(strides))
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    if b * n * h == 0:
        return out, lse
    # 16-byte row loads need d, every q/k/v stride and base 8-aligned
    vec = int(d % 8 == 0 and all(x % 8 == 0 for x in strides[:9])
              and q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0
              and v.data_ptr() % 16 == 0)
    err = _cuda.library("flash_attention").flash_attention_fwd(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), lse.data_ptr(), ptrs[0], ptrs[1],
        _STRIDES(*strides), b, n, m, h, d, float(scale), int(bool(causal)),
        vec, _cuda.stream_ptr(dev))
    _cuda.check(err, "flash_attention")
    launches += 1
    return out, lse
