"""OPT decoder-only tower, BLIP-2 OPT's language model (port of
``vlm_compression_tpu/models/opt.py``).

Learned position embeddings with OPT's +2 offset, pre-LayerNorm blocks
(fp32 LayerNorms at eps 1e-5), ReLU FFN, biased linears and an untied,
bias-free LM head.  Every linear is a ``SparseLinear``, so masks and
SparseLoRA adapters apply as in the other towers.  Names follow the Flax
tree (``blocks_<i>/self_attn/q_proj``, ``self_attn_ln``, ``final_ln``,
``embed_tokens/embedding``, ``embed_positions/embedding``,
``final_norm``, ``lm_head``), so ``models/bridge.load_jax_variables``
carries the weights across with no name table.

OPT scales the query by d^-0.5 before the product, so attention runs at
scale 1.  The mask is one additive fp32 bias, as in the JAX package: the
causal −1e9 plus the padding −1e9 for a full sequence; over a KV cache the
padding bias of the whole cache plus ``step_visibility_mask``.  The cached
decode has the interface of ``models/llama.LlamaForCausalLM``
(``init_cache``, ``backbone``, ``logits``), so ``llama.make_causal_step``
drives it unchanged, int8 and per-row caches included.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vlm_compression_tpu_torch.models.kvcache import (
    cache_kv,
    init_kv_cache,
    step_visibility_mask,
)
from vlm_compression_tpu_torch.models.layers import (
    Embed,
    LayerNorm,
    SparseLinear,
)
from vlm_compression_tpu_torch.models.llama import TokenEmbed
from vlm_compression_tpu_torch.models.t5 import (
    causal_mask,
    cross_entropy_loss,
    extend_mask,
)
from vlm_compression_tpu_torch.ops.attention import attention_core

# HF's OPTLearnedPositionalEmbedding: position p reads row p + 2
POSITION_OFFSET = 2


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class OPTConfig:
    vocab_size: int = 50272
    hidden_size: int = 2560
    ffn_dim: int = 10240
    num_layers: int = 32
    num_heads: int = 32
    max_position_embeddings: int = 2048
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    bos_token_id: int = 2
    eos_token_id: int = 2
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    lora_rank: int = 0
    lora_alpha: float = 16.0
    # decode KV cache storage (models/kvcache.py)
    kv_cache_int8: bool = False
    kv_cache_per_row: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @staticmethod
    def opt_2_7b(**kw) -> "OPTConfig":
        return OPTConfig(**kw)

    @staticmethod
    def opt_6_7b(**kw) -> "OPTConfig":
        d = dict(hidden_size=4096, ffn_dim=16384, num_layers=32,
                 num_heads=32)
        d.update(kw)
        return OPTConfig(**d)

    @staticmethod
    def tiny(**kw) -> "OPTConfig":
        d = dict(vocab_size=96, hidden_size=16, ffn_dim=32, num_layers=2,
                 num_heads=2, max_position_embeddings=64)
        d.update(kw)
        return OPTConfig(**d)


def _sl(cfg: OPTConfig, in_features: int, features: int, device):
    return SparseLinear(in_features, features, True, _dt(cfg.param_dtype),
                        device, lora_rank=cfg.lora_rank,
                        lora_alpha=cfg.lora_alpha)


class OPTAttention(nn.Module):
    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            self.add_module(name, _sl(cfg, cfg.hidden_size, cfg.hidden_size,
                                      device))

    def forward(self, x, mask, mode="masked", cache: Optional[dict] = None):
        """``mask``: the additive bias over the keys (over the whole cache,
        visibility included, when ``cache`` is given)."""
        cfg = self.cfg
        hd = cfg.head_dim
        b, n, _ = x.shape
        q = (self.q_proj(x, mode=mode) * (hd ** -0.5)).reshape(
            b, n, cfg.num_heads, hd)
        k = self.k_proj(x, mode=mode).reshape(b, n, cfg.num_heads, hd)
        v = self.v_proj(x, mode=mode).reshape(b, n, cfg.num_heads, hd)
        if cache is not None:
            k, v, _ = cache_kv(cache, k, v)
        out = attention_core(q, k, v, [mask], scale=1.0)
        return self.out_proj(out.reshape(b, n, cfg.hidden_size), mode=mode)


class OPTBlock(nn.Module):
    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        self.self_attn_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                      device)
        self.self_attn = OPTAttention(cfg, device)
        self.final_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.fc1 = _sl(cfg, cfg.hidden_size, cfg.ffn_dim, device)
        self.fc2 = _sl(cfg, cfg.ffn_dim, cfg.hidden_size, device)

    def forward(self, x, mask=None, mode="masked",
                cache: Optional[dict] = None):
        h = self.self_attn_ln(x).to(x.dtype)
        x = x + self.self_attn(h, mask, mode=mode, cache=cache)
        h = self.final_ln(x).to(x.dtype)
        h = torch.relu(self.fc1(h, mode=mode))
        return x + self.fc2(h, mode=mode)


class OPTForCausalLM(nn.Module):
    """Decoder-only LM; blocks ``blocks_<i>`` as the calibration engine
    addresses them."""

    def __init__(self, cfg: OPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = _dt(cfg.param_dtype)
        self.embed_tokens = TokenEmbed(cfg.vocab_size, cfg.hidden_size, pdt,
                                       _dt(cfg.dtype), device)
        self.embed_positions = Embed(
            cfg.max_position_embeddings + POSITION_OFFSET, cfg.hidden_size,
            pdt, device)
        self.block_names = [f"blocks_{i}" for i in range(cfg.num_layers)]
        for name in self.block_names:
            self.add_module(name, OPTBlock(cfg, device))
        self.final_norm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
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
            {"self": init_kv_cache(batch, max_len, cfg.num_heads,
                                   cfg.head_dim, dtype, device,
                                   cfg.kv_cache_int8, cfg.kv_cache_per_row)}
            for _ in self.block_names]}

    def backbone(self, inputs_embeds, attention_mask=None, positions=None,
                 mode="masked", cache: Optional[dict] = None):
        """Position embeddings, the blocks and the final norm.  Without a
        cache: causal −1e9 plus the padding bias, positions
        ``max(cumsum(mask) − 1, 0)``.  With one, ``attention_mask`` covers
        the FULL cache and masks its pad slots; causality comes from the
        write index."""
        b, n, _ = inputs_embeds.shape
        dev = inputs_embeds.device
        if positions is None:
            if attention_mask is not None and cache is None:
                positions = torch.clamp(
                    torch.cumsum(attention_mask, dim=-1) - 1, min=0)
            else:
                positions = torch.arange(n, device=dev)[None].expand(b, n)
        x = inputs_embeds + self.embed_positions(
            positions + POSITION_OFFSET).to(inputs_embeds.dtype)
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
            x = blk(x, mask, mode=mode,
                    cache=cache["layers"][i]["self"] if cache is not None
                    else None)
        return self.final_norm(x)

    def logits(self, hidden, mode="masked"):
        """fp32 logits through the LM head (its own mode, as in the JAX
        package)."""
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
