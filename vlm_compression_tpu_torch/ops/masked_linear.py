"""Masked matmul — the sparse forward path: y = x · (W ⊙ M).

Counterpart of ``vlm_compression_tpu/ops/masked_linear.py`` (the
``masked`` mode only; the sparse-LoRA, LoRA and packed-mask variants come
with later slices).  Layout as there: x (..., in), W (in, out), mask
(in, out) bool, True = keep.

``masked_matmul`` runs the plain version on CPU tensors and the
hand-written kernel ``csrc/masked_matmul.cu`` on CUDA tensors (it launches
or raises — there is no fallback).  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from vlm_compression_tpu_torch.ops import _cuda

launches = 0


def masked_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Plain version: fp32 accumulation, cast to x's dtype (the JAX
    reference's dot_general with preferred_element_type=float32)."""
    wm = torch.where(mask, w, torch.zeros((), dtype=w.dtype, device=w.device))
    return torch.matmul(x.float(), wm.float()).to(x.dtype)


def masked_matmul(x: torch.Tensor, w: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """y = x @ (w ⊙ mask); the masked weight never exists in memory on the
    card."""
    if x.device.type == "cpu":
        return masked_matmul_ref(x, w, mask)
    return _masked_matmul_cuda(x, w, mask)


# the bf16 kernel's output tile and K step (csrc/masked_matmul.cu)
_BM, _BN, _BK = 128, 128, 32


def split_k(m: int, n: int, k: int, sms: int):
    """(splits, k_split) for the bf16 kernel: when the output tiles cannot
    fill the card (decode-sized M), split K so that about two blocks per SM
    stream the weight, each split at least 4 K steps long."""
    tiles = -(-m // _BM) * -(-n // _BN)
    splits = 1
    if tiles < sms:
        splits = max(1, min(-(-2 * sms // tiles), k // (4 * _BK)))
    k_split = -(-(-(-k // splits)) // _BK) * _BK
    return -(-k // k_split), k_split


def _check_inputs(x, w, mask):
    """Raise the specific error for inputs the kernel does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"masked_matmul: unsupported device {x.device}")
    if w.ndim != 2 or x.shape[-1] != w.shape[0] or mask.shape != w.shape:
        raise ValueError(f"masked_matmul: shapes x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, mask {tuple(mask.shape)}")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"masked_matmul: x {x.dtype} and w {w.dtype} must "
                        "both be bfloat16 or both float32")
    if mask.dtype != torch.bool:
        raise TypeError(f"masked_matmul: mask must be bool, got {mask.dtype}")
    if w.device != x.device or mask.device != x.device:
        raise ValueError("masked_matmul: x, w and mask must share a device")
    raise ValueError("masked_matmul: w and mask must be contiguous")


_DTYPES = (torch.bfloat16, torch.float32)


def _masked_matmul_cuda(x, w, mask):
    global launches
    dev = x.device
    if not (dev.type == "cuda" and w.ndim == 2 and mask.shape == w.shape
            and x.shape[-1] == w.shape[0] and x.dtype == w.dtype
            and x.dtype in _DTYPES and mask.dtype == torch.bool
            and w.device == dev and mask.device == dev
            and w.is_contiguous() and mask.is_contiguous()):
        _check_inputs(x, w, mask)
    k, n = w.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    if m == 0 or n == 0:
        return y.reshape(*lead, n)
    if k == 0:
        return y.zero_().reshape(*lead, n)
    lib = _cuda.library("masked_matmul")
    stream = _cuda.stream_ptr(dev)
    if x.dtype == torch.bfloat16:
        vec = int(k % 8 == 0 and n % 8 == 0
                  and x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
                  and mask.data_ptr() % 8 == 0)
        splits, k_split = split_k(m, n, k, _cuda.sm_count(dev))
        work = (torch.empty((splits, m, n), dtype=torch.float32, device=dev)
                if splits > 1 else None)
        err = lib.masked_matmul_bf16(
            x2.data_ptr(), w.data_ptr(), mask.data_ptr(), y.data_ptr(),
            None if work is None else work.data_ptr(), m, n, k, splits,
            k_split, vec, stream)
    else:
        err = lib.masked_matmul_f32(x2.data_ptr(), w.data_ptr(),
                                    mask.data_ptr(), y.data_ptr(),
                                    m, n, k, stream)
    _cuda.check(err, "masked_matmul")
    launches += 1
    return y.reshape(*lead, n)
