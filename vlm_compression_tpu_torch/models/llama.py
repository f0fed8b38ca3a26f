"""LLaMA / Vicuna decoder-only tower (port of
``vlm_compression_tpu/models/llama.py``).

RMSNorm (fp32 statistics, fp32 ``scale``), rotary position embeddings
(tables from numpy in fp64, cast to fp32; the rotation in fp32, then a cast
back), SwiGLU MLP; every linear is a ``SparseLinear``, so masks and
SparseLoRA adapters apply as in the other towers.  Names follow the Flax
tree (``blocks_<i>/self_attn/q_proj``, ``embed_tokens/embedding``,
``input_ln/scale``, …), so ``models/bridge.load_jax_variables`` carries the
weights across with no name table.

The attention mask is one additive fp32 bias, as in the JAX package: the
causal −1e9 mask plus the padding bias for a full sequence; over a KV cache
the padding bias of the whole cache plus ``step_visibility_mask``.  The
causal flag of ``attention_core`` is not used.

The cached decode takes a cache dict of per-layer ``self`` buffers
(``models/kvcache.py``) instead of Flax's mutable collection, shaped as the
T5 decoder's, so ``generation._gather_beams`` reorders it unchanged;
``kv_cache_int8`` / ``kv_cache_per_row`` choose its storage
(``models/kvcache.py``).  ``use_remat`` checkpoints each block of a
full-sequence pass; the cached decode is never checkpointed.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from vlm_compression_tpu_torch.models.kvcache import (
    cache_kv,
    init_kv_cache,
    step_visibility_mask,
)
from vlm_compression_tpu_torch.models.layers import (
    COL,
    ROW,
    contiguous_plan,
    Embed,
    SparseLinear,
    run_block,
)
from vlm_compression_tpu_torch.models.t5 import (
    RMSNorm,
    causal_mask,
    cross_entropy_loss,
    extend_mask,
)
from vlm_compression_tpu_torch.ops.attention import attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # decode KV cache storage (models/kvcache.py)
    kv_cache_int8: bool = False
    kv_cache_per_row: bool = False
    use_remat: bool = False   # checkpoint each block (not the cached decode)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def vicuna_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def vicuna_13b(**kw) -> "LlamaConfig":
        d = dict(hidden_size=5120, intermediate_size=13824, num_layers=40,
                 num_heads=40)
        d.update(kw)
        return LlamaConfig(**d)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        d = dict(vocab_size=96, hidden_size=16, intermediate_size=32,
                 num_layers=2, num_heads=2, max_position_embeddings=64)
        d.update(kw)
        return LlamaConfig(**d)


# LLaMA's RMSNorm is T5's: scale only, fp32 variance, no mean subtraction
LlamaRMSNorm = RMSNorm


@functools.lru_cache(maxsize=8)
def rotary_tables(head_dim: int, max_len: int, theta: float,
                  device: str = "cpu"):
    """(cos, sin) (max_len, head_dim) fp32, computed in fp64 with numpy as
    the JAX package does; one copy per device."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_len), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    return (torch.from_numpy(np.cos(emb)).float().to(device),
            torch.from_numpy(np.sin(emb)).float().to(device))


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary(q, k, cos, sin, positions):
    """q/k (b, n, h, d); positions (b, n)."""
    c = cos[positions][:, :, None, :]
    s = sin[positions][:, :, None, :]
    q2, k2 = q.float(), k.float()
    q_out = q2 * c + rotate_half(q2) * s
    k_out = k2 * c + rotate_half(k2) * s
    return q_out.to(q.dtype), k_out.to(k.dtype)


def _sl(cfg: LlamaConfig, in_features: int, features: int, device):
    return SparseLinear(in_features, features, False, _dt(cfg.param_dtype),
                        device, lora_rank=cfg.lora_rank,
                        lora_alpha=cfg.lora_alpha)


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            self.add_module(name, _sl(cfg, cfg.hidden_size, cfg.hidden_size,
                                      device))
        self.heads = cfg.num_heads

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        """h/t local heads: q/k/v_proj column-parallel, o_proj
        row-parallel.  The rule table stores every ``*_proj`` kernel by
        rows (``proj`` matches first), so the column-parallel ones gather
        their stored blocks for the call and index the rank's columns."""
        cfg = self.cfg
        if cfg.num_heads % size:
            return
        self.heads = cfg.num_heads // size
        for name in ("q_proj", "k_proj", "v_proj"):
            getattr(self, name).tp = contiguous_plan(COL, group, size, rank,
                                                     cfg.hidden_size)
        self.o_proj.tp = contiguous_plan(ROW, group, size, rank,
                                         cfg.hidden_size)

    def clear_tensor_parallel_(self) -> None:
        self.heads = self.cfg.num_heads

    def forward(self, x, mask, positions, mode="masked",
                cache: Optional[dict] = None):
        """``mask``: the additive bias over the keys (over the whole cache,
        visibility included, when ``cache`` is given)."""
        cfg = self.cfg
        hd = cfg.head_dim
        b, n, _ = x.shape
        q = self.q_proj(x, mode=mode).reshape(b, n, self.heads, hd)
        k = self.k_proj(x, mode=mode).reshape(b, n, self.heads, hd)
        v = self.v_proj(x, mode=mode).reshape(b, n, self.heads, hd)
        cos, sin = rotary_tables(hd, cfg.max_position_embeddings,
                                 cfg.rope_theta, str(x.device))
        q, k = apply_rotary(q, k, cos, sin, positions)
        if cache is not None:
            k, v, _ = cache_kv(cache, k, v)
        out = attention_core(q, k, v, [mask], scale=float(hd) ** -0.5)
        return self.o_proj(out.reshape(b, n, self.heads * hd), mode=mode)


class LlamaMLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) ⊙ up(x))."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.gate_proj = _sl(cfg, cfg.hidden_size, cfg.intermediate_size,
                             device)
        self.up_proj = _sl(cfg, cfg.hidden_size, cfg.intermediate_size,
                           device)
        self.down_proj = _sl(cfg, cfg.intermediate_size, cfg.hidden_size,
                             device)

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        inter = self.down_proj.in_features
        if inter % size == 0:
            for lin in (self.gate_proj, self.up_proj):
                lin.tp = contiguous_plan(COL, group, size, rank, inter)
            self.down_proj.tp = contiguous_plan(ROW, group, size, rank, inter)

    def forward(self, x, mode="masked"):
        gate = nn.functional.silu(self.gate_proj(x, mode=mode))
        return self.down_proj(gate * self.up_proj(x, mode=mode), mode=mode)


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.input_ln = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps, device)
        self.self_attn = LlamaAttention(cfg, device)
        self.post_attn_ln = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                         device)
        self.mlp = LlamaMLP(cfg, device)

    def forward(self, x, mask=None, positions=None, mode="masked",
                cache: Optional[dict] = None):
        x = x + self.self_attn(self.input_ln(x), mask, positions, mode=mode,
                               cache=cache)
        return x + self.mlp(self.post_attn_ln(x), mode=mode)


class TokenEmbed(Embed):
    """``embed_tokens``: the gather, cast to the compute dtype."""

    def __init__(self, num: int, features: int, param_dtype: torch.dtype,
                 dtype: torch.dtype, device=None):
        super().__init__(num, features, param_dtype, device)
        self.dtype = dtype

    def forward(self, ids):
        return self.lookup(ids).to(self.dtype)


class LlamaForCausalLM(nn.Module):
    """Decoder-only LM; blocks ``blocks_<i>`` as the calibration engine
    addresses them."""

    def __init__(self, cfg: LlamaConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = _dt(cfg.param_dtype)
        self.embed_tokens = TokenEmbed(cfg.vocab_size, cfg.hidden_size, pdt,
                                       _dt(cfg.dtype), device)
        self.block_names = [f"blocks_{i}" for i in range(cfg.num_layers)]
        for name in self.block_names:
            self.add_module(name, LlamaBlock(cfg, device))
        self.final_norm = LlamaRMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device)
        self.lm_head = SparseLinear(cfg.hidden_size, cfg.vocab_size, False,
                                    pdt, device)

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device) -> dict:
        """Empty per-layer k/v buffers of ``max_len`` slots, in the
        config's int8 / per-row storage."""
        cfg = self.cfg
        return {"layers": [
            {"self": init_kv_cache(batch, max_len, blk.self_attn.heads,
                                   cfg.head_dim, dtype, device,
                                   cfg.kv_cache_int8, cfg.kv_cache_per_row)}
            for blk in self.blocks()]}

    def backbone(self, inputs_embeds, attention_mask=None, positions=None,
                 mode="masked", cache: Optional[dict] = None):
        """The blocks and the final norm.  Without a cache: causal −1e9
        mask plus the padding bias, positions ``cumsum(mask) − 1``.  With
        one, ``attention_mask`` covers the FULL cache and masks its pad
        slots; causality comes from the write index."""
        x = inputs_embeds
        b, n, _ = x.shape
        dev = x.device
        if positions is None:
            if attention_mask is not None and cache is None:
                positions = torch.clamp(
                    torch.cumsum(attention_mask, dim=-1) - 1, min=0)
            else:
                positions = torch.arange(n, device=dev)[None].expand(b, n)
        if cache is not None:
            first = cache["layers"][0]["self"]
            mask = step_visibility_mask(first["index"], n,
                                        first["key"].shape[1],
                                        extend_mask(attention_mask),
                                        device=dev)
        else:
            mask = causal_mask(n, device=dev)
            if attention_mask is not None:
                mask = mask + extend_mask(attention_mask)
        for i, blk in enumerate(self.blocks()):
            if cache is not None:       # the cached decode: never remat'd
                x = blk(x, mask, positions, mode=mode,
                        cache=cache["layers"][i]["self"])
            else:
                x = run_block(blk, x, mask, positions, mode=mode,
                              remat=self.cfg.use_remat)
        return self.final_norm(x)

    def logits(self, hidden, mode="masked"):
        """fp32 logits through the fp32 ``lm_head`` (no mask: a plain
        product, as in the JAX package)."""
        return self.lm_head(hidden.float(), mode=mode).float()

    def forward(self, input_ids=None, attention_mask=None, inputs_embeds=None,
                labels=None, positions=None, mode="masked",
                cache: Optional[dict] = None):
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        h = self.backbone(inputs_embeds, attention_mask, positions, mode=mode,
                          cache=cache)
        logits = self.logits(h, mode)
        if labels is None:
            return logits
        # causal shift: predict token t+1 at position t
        return {"loss": cross_entropy_loss(logits[:, :-1], labels[:, 1:]),
                "logits": logits}


def make_causal_step(model: LlamaForCausalLM, prefix_embeds,
                     prefix_mask=None, mode: str = "masked",
                     max_decode_len: int = 32):
    """(step_fn, cache) for ``generation.py``.

    The prompt prefix (every token but the last) primes the cache in one
    call; the decode loop then starts from the last prompt token.
    ``prefix_mask`` (b, p) masks pad slots of the prefix for the whole
    decode, and the rotary positions count only valid tokens: the prime
    takes ``cumsum(prefix_mask) − 1``, a step ``valid + (cur − p)`` (the
    write frontier ``cur``, per row for a per-row cache; a multi-token
    chunk, speculative decoding's verify, takes consecutive positions from
    it), repeated per beam when the step's batch is a multiple of b.  The
    prime stops at the final norm: its logits are thrown away (the JAX
    package computes them, in fp32 through the LM head, and drops them)."""
    b, p, _ = prefix_embeds.shape
    dev = prefix_embeds.device
    cache = model.init_cache(b, p + max_decode_len, prefix_embeds.dtype, dev)
    if prefix_mask is not None:
        prefix_mask = prefix_mask.to(torch.int32)
        full_mask = torch.cat([prefix_mask, torch.ones(
            (b, max_decode_len), dtype=torch.int32, device=dev)], dim=1)
        prime_pos = torch.clamp(torch.cumsum(prefix_mask, dim=-1) - 1, min=0)
        valid_count = prefix_mask.sum(-1)
    else:
        full_mask = None
        prime_pos = torch.arange(p, device=dev)[None].expand(b, p)
        valid_count = torch.full((b,), p, dtype=torch.int64, device=dev)
    model.backbone(prefix_embeds, full_mask, prime_pos, mode=mode,
                   cache=cache)

    def step_fn(tokens, cache):
        cur = cache["layers"][0]["self"]["index"]
        reps = tokens.shape[0] // b
        vc = valid_count.repeat_interleave(reps) if reps > 1 else valid_count
        positions = ((vc + (cur - p))[:, None]
                     + torch.arange(tokens.shape[1], device=dev)[None, :])
        mask = full_mask
        if mask is not None and reps > 1:
            mask = mask.repeat_interleave(reps, dim=0)
        logits = model(input_ids=tokens, attention_mask=mask,
                       positions=positions, mode=mode, cache=cache)
        return logits, cache

    return step_fn, cache
