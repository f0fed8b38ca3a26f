"""Decode-time KV cache (port of ``vlm_compression_tpu/models/kvcache.py``).

A layer's self-attention cache is a dict of ``key``/``value`` buffers
(b, max_len, h, d) and the write ``index``.  ``cache_kv`` writes this
step's k/v IN PLACE at the index (the JAX package rewrote the buffers
functionally; in place saves a full copy per step) and advances it.

Two storage options, as in the JAX package:

* **int8** (``init_kv_cache(..., int8=True)``): ``key``/``value`` hold int8
  codes and ``key_scale``/``value_scale`` one fp32 absmax scale per (batch,
  slot, head) — half the persistent decode memory of bf16.  ``cache_kv``
  returns the whole cache dequantized (a plain elementwise op); the
  attention is unchanged.
* **per-row** (``per_row=True``): ``index`` is a (b,) int64 tensor and
  every row writes at its own frontier, so speculative decoding commits
  each row's own accepted prefix instead of the batch minimum.  The cache
  then also holds ``bound``, a host int no row's index exceeds (kept by
  ``cache_kv`` and by ``generation.rollback_cache``), so a full cache
  raises without reading the index back from the card.
"""

from __future__ import annotations

import torch

from vlm_compression_tpu_torch.ops.attention import NEG_INF


def quantize_kv(x: torch.Tensor):
    """(b, n, h, d) → int8 codes + fp32 scales (b, n, h): codes
    ``round(x / scale)`` (half to even) clipped to ±127, ``scale =
    max(absmax, 1e-8) / 127``."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1), min=1e-8) / 127.0
    codes = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scales: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (codes.float() * scales[..., None]).to(dtype)


def init_kv_cache(batch: int, max_len: int, heads: int, head_dim: int,
                  dtype: torch.dtype, device, int8: bool = False,
                  per_row: bool = False) -> dict:
    shape = (batch, max_len, heads, head_dim)
    store = torch.int8 if int8 else dtype
    cache = {"key": torch.zeros(shape, dtype=store, device=device),
             "value": torch.zeros(shape, dtype=store, device=device),
             "index": 0}
    if int8:
        cache["key_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                         device=device)
        cache["value_scale"] = torch.zeros(shape[:3], dtype=torch.float32,
                                           device=device)
    if per_row:
        cache["index"] = torch.zeros(batch, dtype=torch.int64, device=device)
        cache["bound"] = 0
    return cache


def is_per_row(cache: dict) -> bool:
    return isinstance(cache["index"], torch.Tensor)


def row_update_(buf: torch.Tensor, upd: torch.Tensor, cur: torch.Tensor):
    """Write ``upd`` (b, n, ...) into ``buf`` (b, N, ...) in place from the
    per-row slot ``cur`` (b,) on: row r's slots cur[r] … cur[r] + n − 1."""
    b, n = upd.shape[:2]
    rows = torch.arange(b, device=buf.device)[:, None]
    slots = cur[:, None] + torch.arange(n, device=buf.device)[None, :]
    buf[rows, slots] = upd


def cache_kv(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """Write this step's (b, n, h, d) k/v at the cache index; returns the
    full buffers (dequantized to k's dtype for an int8 cache) and the write
    position BEFORE this step (an int, or (b,) for a per-row cache)."""
    cur = cache["index"]
    n = k.shape[1]
    size = cache["key"].shape[1]
    per_row = is_per_row(cache)
    top = cache["bound"] if per_row else cur
    if top + n > size:
        raise ValueError(f"KV cache full: {top} + {n} > {size}")
    if "key_scale" in cache:
        parts = (("key",) + quantize_kv(k), ("value",) + quantize_kv(v))
        writes = [(cache[name], codes) for name, codes, _ in parts]
        writes += [(cache[name + "_scale"], scales)
                   for name, _, scales in parts]
    else:
        writes = [(cache["key"], k), (cache["value"], v)]
    for buf, upd in writes:
        if per_row:
            row_update_(buf, upd, cur)
        else:
            buf[:, cur:cur + n] = upd
    cache["index"] = cur + n
    if per_row:
        cache["bound"] = top + n
    if "key_scale" in cache:
        return (dequantize_kv(cache["key"], cache["key_scale"], k.dtype),
                dequantize_kv(cache["value"], cache["value_scale"], v.dtype),
                cur)
    return cache["key"], cache["value"], cur


def step_visibility_mask(cur, n: int, max_len: int, prev_mask=None,
                         device=None):
    """Per-query causal visibility over the cache: query cur+i sees slots
    j ≤ cur+i.  ``cur``: an int (→ an additive (1, 1, n, max_len) float32
    mask) or a (b,) tensor of per-row frontiers (→ (b, 1, n, max_len))."""
    if isinstance(cur, torch.Tensor):
        qpos = cur.reshape(-1, 1) + torch.arange(n, device=cur.device)
    else:
        qpos = cur + torch.arange(n, device=device)[None]
    dev = qpos.device
    vis = (torch.arange(max_len, device=dev)[None, None, None, :]
           <= qpos[:, None, :, None])
    step = torch.where(vis, torch.zeros((), device=dev),
                       torch.full((), NEG_INF, device=dev))
    return step if prev_mask is None else prev_mask + step
