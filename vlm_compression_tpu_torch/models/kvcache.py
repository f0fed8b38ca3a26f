"""Decode-time KV cache (port of ``vlm_compression_tpu/models/kvcache.py``,
bf16/fp32 storage; the int8 and per-row variants come later).

A layer's self-attention cache is a dict of ``key``/``value`` buffers
(b, max_len, h, d) and the write ``index``.  ``cache_kv`` writes this
step's k/v IN PLACE at the index (the JAX package rewrote the buffers
functionally; in place saves a full copy per step) and advances it.
"""

from __future__ import annotations

import torch

from vlm_compression_tpu_torch.ops.attention import NEG_INF


def init_kv_cache(batch: int, max_len: int, heads: int, head_dim: int,
                  dtype: torch.dtype, device) -> dict:
    shape = (batch, max_len, heads, head_dim)
    return {"key": torch.zeros(shape, dtype=dtype, device=device),
            "value": torch.zeros(shape, dtype=dtype, device=device),
            "index": 0}


def cache_kv(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """Write this step's (b, n, h, d) k/v at the cache index; returns the
    full buffers and the write position BEFORE this step."""
    cur = cache["index"]
    n = k.shape[1]
    if cur + n > cache["key"].shape[1]:
        raise ValueError(f"KV cache full: {cur} + {n} > "
                         f"{cache['key'].shape[1]}")
    cache["key"][:, cur:cur + n] = k
    cache["value"][:, cur:cur + n] = v
    cache["index"] = cur + n
    return cache["key"], cache["value"], cur


def step_visibility_mask(cur: int, n: int, max_len: int, prev_mask=None,
                         device=None):
    """Per-query causal visibility over the cache: query cur+i sees slots
    j ≤ cur+i.  Returns an additive (1, 1, n, max_len) float32 mask."""
    qpos = cur + torch.arange(n, device=device)
    vis = torch.arange(max_len, device=device)[None, :] <= qpos[:, None]
    step = torch.where(vis, torch.zeros((), device=device),
                       torch.full((), NEG_INF, device=device))[None, None]
    return step if prev_mask is None else prev_mask + step
