"""MED, the BERT of BLIP-1 and ALBEF (port of
``vlm_compression_tpu/models/med.py``).

One trunk serves the three text roles by its arguments: the text encoder
(bidirectional self-attention, no encoder states), the fusion encoder
(cross-attention to image features in the layers from ``fusion_start`` on)
and the causal LM decoder (``causal=True`` with cross-attention, the tied
LM head ``lm_logits``).  Post-LN BERT layers at eps 1e-12 (LayerNorms in
float32), exact GELU, every linear a ``SparseLinear``.  The self-attention
mask becomes one additive float32 bias ``where(mask, 0, -1e9)`` of shape
(b, 1, 1, n), or (b, 1, n, n) with the causal mask folded in; an all-ones
mask is still a bias, as in the JAX package.

The Flax module creates a layer's ``crossattention`` only where the layer
has cross-attention, and the LM head only where the model calls it: the
port builds ``lm_transform`` / ``lm_transform_ln`` when ``lm_head`` is set,
so its parameters are the JAX tree's leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vlm_compression_tpu_torch.models.layers import (
    Embed,
    LayerNorm,
    SparseLinear,
    gelu,
)
from vlm_compression_tpu_torch.ops.attention import NEG_INF, attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class MedConfig:
    vocab_size: int = 30524            # bert-base + [DEC]/[ENC] tokens
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    encoder_width: int = 768           # vision feature dim
    fusion_start: int = 0              # first layer with cross-attention
    layer_norm_eps: float = 1e-12
    param_dtype: str = "float32"
    dtype: str = "bfloat16"
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @staticmethod
    def tiny(**kw) -> "MedConfig":
        d = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                 intermediate_size=32, encoder_width=16,
                 max_position_embeddings=32)
        d.update(kw)
        return MedConfig(**d)


def _sl(cfg: MedConfig, in_features, features, device):
    return SparseLinear(in_features, features,
                        param_dtype=_dt(cfg.param_dtype), device=device,
                        lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)


def mask_bias(mask: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """bool keep-mask → additive float32 bias (0 kept, −1e9 masked)."""
    if mask is None:
        return None
    return torch.where(mask, torch.zeros((), device=mask.device),
                       torch.full((), NEG_INF, device=mask.device))


class MedAttention(nn.Module):
    """Attention + output projection + residual + post-LN; ``kv_width`` is
    the key/value input's width (the encoder's for cross-attention)."""

    def __init__(self, cfg: MedConfig, kv_width: int, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_size
        self.query = _sl(cfg, hd, hd, device)
        self.key = _sl(cfg, kv_width, hd, device)
        self.value = _sl(cfg, kv_width, hd, device)
        self.output_dense = _sl(cfg, hd, hd, device)
        self.output_ln = LayerNorm(hd, cfg.layer_norm_eps, device)

    def forward(self, x, kv, bias, mode="masked"):
        h = self.cfg.num_heads
        d = self.cfg.hidden_size // h
        b, n, _ = x.shape
        m = kv.shape[1]
        q = self.query(x, mode=mode).reshape(b, n, h, d)
        k = self.key(kv, mode=mode).reshape(b, m, h, d)
        v = self.value(kv, mode=mode).reshape(b, m, h, d)
        ctx = attention_core(q, k, v, [bias], scale=float(d) ** -0.5)
        out = self.output_dense(ctx.reshape(b, n, h * d), mode=mode)
        return self.output_ln(out + x).to(x.dtype)


class MedLayer(nn.Module):
    def __init__(self, cfg: MedConfig, has_cross: bool, device=None):
        super().__init__()
        self.has_cross = has_cross
        self.attention = MedAttention(cfg, cfg.hidden_size, device)
        if has_cross:
            self.crossattention = MedAttention(cfg, cfg.encoder_width, device)
        self.intermediate_dense = _sl(cfg, cfg.hidden_size,
                                      cfg.intermediate_size, device)
        self.ffn_output_dense = _sl(cfg, cfg.intermediate_size,
                                    cfg.hidden_size, device)
        self.ffn_output_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                       device)

    def forward(self, x, self_bias, enc_states, enc_bias, mode="masked"):
        x = self.attention(x, x, self_bias, mode=mode)
        if self.has_cross and enc_states is not None:
            x = self.crossattention(x, enc_states.to(x.dtype), enc_bias,
                                    mode=mode)
        h = gelu(self.intermediate_dense(x, mode=mode))
        out = self.ffn_output_dense(h, mode=mode)
        return self.ffn_output_ln(out + x).to(x.dtype)


class MedBert(nn.Module):
    """BERT trunk: ``forward(ids, mask, enc_states?, enc_mask?, causal?)``
    → hidden states; ``inputs_embeds`` skips the embedding (ALBEF's fusion
    half), ``start_layer`` the layers below it."""

    def __init__(self, cfg: MedConfig, lm_head: bool = False, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = _dt(cfg.param_dtype)
        self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size, pdt,
                                     device)
        self.position_embeddings = Embed(cfg.max_position_embeddings,
                                         cfg.hidden_size, pdt, device)
        self.emb_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.layer_names = [f"layers_{i}" for i in range(cfg.num_layers)]
        for i, name in enumerate(self.layer_names):
            self.add_module(name, MedLayer(cfg, i >= cfg.fusion_start,
                                           device))
        if lm_head:
            self.lm_transform = _sl(cfg, cfg.hidden_size, cfg.hidden_size,
                                    device)
            self.lm_transform_ln = LayerNorm(cfg.hidden_size,
                                             cfg.layer_norm_eps, device)

    def layers(self):
        return [getattr(self, name) for name in self.layer_names]

    def embed(self, input_ids):
        n = input_ids.shape[1]
        x = self.word_embeddings(input_ids) \
            + self.position_embeddings.embedding[:n][None]
        return self.emb_ln(x.float()).to(_dt(self.cfg.dtype))

    def self_bias(self, attention_mask, b: int, n: int, causal: bool,
                  device) -> torch.Tensor:
        """The self-attention bias: padding (all ones without a mask), and
        the causal mask with ``causal``."""
        if attention_mask is not None:
            m = attention_mask[:, None, None, :].bool()
        else:
            m = torch.ones((b, 1, 1, n), dtype=torch.bool, device=device)
        if causal:
            i = torch.arange(n, device=device)
            m = m & (i[None, :] <= i[:, None])[None, None]
        return mask_bias(m)

    def forward(self, input_ids=None, attention_mask=None,
                encoder_hidden_states=None, encoder_attention_mask=None,
                causal: bool = False, inputs_embeds=None,
                start_layer: int = 0, mode: str = "masked"):
        x = inputs_embeds if inputs_embeds is not None else self.embed(
            input_ids)
        b, n = x.shape[:2]
        bias = self.self_bias(attention_mask, b, n, causal, x.device)
        enc_bias = None
        if encoder_hidden_states is not None \
                and encoder_attention_mask is not None:
            enc_bias = mask_bias(
                encoder_attention_mask[:, None, None, :].bool())
        for layer in self.layers()[start_layer:]:
            x = layer(x, bias, encoder_hidden_states, enc_bias, mode=mode)
        return x

    def lm_logits(self, hidden, mode: str = "masked"):
        """The tied LM head: transform, exact GELU, LayerNorm, then the
        float32 product with the word embeddings."""
        h = gelu(self.lm_transform(hidden, mode=mode))
        h = self.lm_transform_ln(h)
        return h @ self.word_embeddings.embedding.float().T


def lm_loss(logits, labels, label_mask=None, label_smoothing: float = 0.1):
    """Shifted causal LM loss with label smoothing (the decoder's)."""
    logits = logits[:, :-1]
    targets = labels[:, 1:]
    mask = (label_mask[:, 1:] if label_mask is not None
            else targets >= 0).float()
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = targets.clamp(0, logits.shape[-1] - 1).long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    smooth = -logp.mean(-1)
    loss = (1 - label_smoothing) * nll + label_smoothing * smooth
    return (loss * mask).sum() / mask.sum().clamp(min=1.0)
