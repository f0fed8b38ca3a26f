"""Q-Former bridge (port of ``vlm_compression_tpu/models/qformer.py``):
BERT with interleaved cross-attention to the vision features.

32 learned queries attend jointly with the instruction text; every
``cross_attention_freq``-th layer cross-attends the query positions to the
image features; query and text positions use separate FFNs.  Post-LN.
Names follow the Flax tree (``layers_<i>/attention/self/query``, …).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vlm_compression_tpu_torch.models.layers import (
    COL,
    ROW,
    contiguous_plan,
    Embed,
    LayerNorm,
    SparseLinear,
    gelu,
)
from vlm_compression_tpu_torch.ops.attention import NEG_INF, attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class QFormerConfig:
    vocab_size: int = 30523            # bert-base-uncased + [DEC] token
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    cross_attention_freq: int = 2
    encoder_width: int = 1408          # vision feature dim
    num_query_tokens: int = 32
    layer_norm_eps: float = 1e-12
    lora_rank: int = 0
    lora_alpha: float = 16.0
    param_dtype: str = "float32"
    dtype: str = "bfloat16"

    @staticmethod
    def tiny(**kw) -> "QFormerConfig":
        d = dict(vocab_size=64, hidden_size=16, num_layers=2, num_heads=2,
                 intermediate_size=32, encoder_width=16, num_query_tokens=4,
                 max_position_embeddings=32)
        d.update(kw)
        return QFormerConfig(**d)


def _sl(cfg, in_features, features, device):
    return SparseLinear(in_features, features,
                        param_dtype=_dt(cfg.param_dtype), device=device,
                        lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: QFormerConfig, kv_width: int, device=None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_size
        self.query = _sl(cfg, hd, hd, device)
        self.key = _sl(cfg, kv_width, hd, device)
        self.value = _sl(cfg, kv_width, hd, device)
        self.heads = cfg.num_heads

    def forward(self, x, kv, mask, mode="masked"):
        cfg = self.cfg
        h, d = self.heads, cfg.hidden_size // cfg.num_heads
        b, n, _ = x.shape
        m = kv.shape[1]
        q = self.query(x, mode=mode).reshape(b, n, h, d)
        k = self.key(kv, mode=mode).reshape(b, m, h, d)
        v = self.value(kv, mode=mode).reshape(b, m, h, d)
        bias = None
        if mask is not None:
            bias = torch.where(mask, torch.zeros((), device=mask.device),
                               torch.full((), NEG_INF, device=mask.device))
        return attention_core(q, k, v, [bias],
                              scale=float(d) ** -0.5).reshape(b, n, h * d)


class BertAttention(nn.Module):
    def __init__(self, cfg: QFormerConfig, is_cross: bool = False,
                 device=None):
        super().__init__()
        kv_width = cfg.encoder_width if is_cross else cfg.hidden_size
        self.self = BertSelfAttention(cfg, kv_width, device)
        self.output_dense = _sl(cfg, cfg.hidden_size, cfg.hidden_size, device)
        self.output_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        """h/t local heads: query, key and value column-parallel (their
        stored blocks), output_dense row-parallel over the same features
        (the rule table replicates it: each rank reads its rows)."""
        cfg = self.self.cfg
        if cfg.num_heads % size:
            return
        self.self.heads = cfg.num_heads // size
        for lin in (self.self.query, self.self.key, self.self.value):
            lin.tp = contiguous_plan(COL, group, size, rank,
                                     cfg.hidden_size)
        self.output_dense.tp = contiguous_plan(ROW, group, size, rank,
                                               cfg.hidden_size)

    def clear_tensor_parallel_(self) -> None:
        self.self.heads = self.self.cfg.num_heads

    def forward(self, x, kv, mask, mode="masked"):
        ctx = self.self(x, kv if kv is not None else x, mask, mode=mode)
        out = self.output_dense(ctx, mode=mode)
        return self.output_ln(out + x).to(x.dtype)


class BertFFN(nn.Module):
    def __init__(self, cfg: QFormerConfig, device=None):
        super().__init__()
        self.intermediate_dense = _sl(cfg, cfg.hidden_size,
                                      cfg.intermediate_size, device)
        self.output_dense = _sl(cfg, cfg.intermediate_size, cfg.hidden_size,
                                device)
        self.output_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        hidden = self.intermediate_dense.features
        if hidden % size == 0:
            self.intermediate_dense.tp = contiguous_plan(COL, group, size,
                                                         rank, hidden)
            self.output_dense.tp = contiguous_plan(ROW, group, size, rank,
                                                   hidden)

    def forward(self, x, mode="masked"):
        h = gelu(self.intermediate_dense(x, mode=mode))
        out = self.output_dense(h, mode=mode)
        return self.output_ln(out + x).to(x.dtype)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, has_cross_attention: bool,
                 device=None, text: bool = True):
        super().__init__()
        self.attention = BertAttention(cfg, device=device)
        self.has_cross_attention = has_cross_attention
        if has_cross_attention:
            self.crossattention = BertAttention(cfg, is_cross=True,
                                                device=device)
        self.ffn_query = BertFFN(cfg, device)
        if text:
            self.ffn = BertFFN(cfg, device)

    def forward(self, x, self_mask, image_embeds, image_mask,
                query_length: int, mode="masked"):
        x = self.attention(x, None, self_mask, mode=mode)
        if query_length > 0:
            q_part = x[:, :query_length]
            if self.has_cross_attention:
                q_part = self.crossattention(q_part, image_embeds, image_mask,
                                             mode=mode)
            q_out = self.ffn_query(q_part, mode=mode)
            if x.shape[1] > query_length:
                t_out = self.ffn(x[:, query_length:], mode=mode)
                return torch.cat([q_out, t_out], dim=1)
            return q_out
        return self.ffn(x, mode=mode)


class QFormer(nn.Module):
    """forward(image_embeds, text_ids?, text_mask?) → the full [query; text]
    hidden states; callers slice the first ``num_query_tokens``.

    ``text=False`` builds the queries-only Q-Former of BLIP-2 OPT: no word
    and position embeddings and no text FFN, the parameters its JAX tree
    holds (Flax creates the text branch only where it runs)."""

    def __init__(self, cfg: QFormerConfig, device=None, text: bool = True):
        super().__init__()
        self.cfg = cfg
        pdt = _dt(cfg.param_dtype)
        self.query_tokens = nn.Parameter(torch.empty(
            (1, cfg.num_query_tokens, cfg.hidden_size), dtype=pdt,
            device=device))
        if text:
            self.word_embeddings = Embed(cfg.vocab_size, cfg.hidden_size,
                                         pdt, device)
            self.position_embeddings = Embed(cfg.max_position_embeddings,
                                             cfg.hidden_size, pdt, device)
        self.emb_ln = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps, device)
        self.layer_names = [f"layers_{i}" for i in range(cfg.num_layers)]
        for i, name in enumerate(self.layer_names):
            self.add_module(name, QFormerLayer(
                cfg, i % cfg.cross_attention_freq == 0, device, text))

    def embed(self, text_ids: Optional[torch.Tensor]):
        """Queries (+ embedded text), LayerNorm over the concatenation."""
        cfg = self.cfg
        q = self.query_tokens.float()
        if text_ids is not None:
            te = self.word_embeddings(text_ids)
            pos = self.position_embeddings(
                torch.arange(text_ids.shape[1], device=text_ids.device))
            te = (te + pos[None]).float()
            b = text_ids.shape[0]
            x = torch.cat([q.expand(b, q.shape[1], q.shape[2]), te], dim=1)
        else:
            x = q
        return self.emb_ln(x).to(_dt(cfg.dtype))

    def embed_text_only(self, text_ids):
        """Text embeddings without the query tokens (the stage-1 ITC text
        branch)."""
        te = self.word_embeddings(text_ids)
        pos = self.position_embeddings(
            torch.arange(text_ids.shape[1], device=text_ids.device))
        x = (te + pos[None]).float()
        return self.emb_ln(x).to(_dt(self.cfg.dtype))

    def forward_text(self, text_ids, text_mask=None, causal: bool = False,
                     mode: str = "masked"):
        """Text-only encoder pass (query_length 0: no cross-attention, no
        query FFN)."""
        x = self.embed_text_only(text_ids)
        b, n = x.shape[:2]
        if text_mask is not None:
            m = text_mask[:, None, None, :].bool()
        else:
            m = torch.ones((b, 1, 1, n), dtype=torch.bool, device=x.device)
        if causal:
            i = torch.arange(n, device=x.device)
            m = m & (i[None, :] <= i[:, None])[None, None]
        for name in self.layer_names:
            x = getattr(self, name)(x, m, None, None, 0, mode=mode)
        return x

    def forward_multimodal(self, image_embeds, text_ids, text_mask=None,
                           causal_text: bool = False, mode: str = "masked"):
        """[queries ⊕ text] with image cross-attention.  ``causal_text``
        gives the stage-1 LM pattern ``(j < ql) | (j <= i)``: queries see
        each other, text sees the queries and its own past."""
        cfg = self.cfg
        x = self.embed(text_ids)
        b = image_embeds.shape[0]
        if x.shape[0] == 1 and b > 1:
            x = x.expand((b,) + tuple(x.shape[1:]))
        ql = cfg.num_query_tokens
        n = x.shape[1]
        tmask = (text_mask if text_mask is not None else
                 torch.ones((b, n - ql), dtype=torch.int32, device=x.device))
        valid = torch.cat([torch.ones((b, ql), dtype=tmask.dtype,
                                      device=tmask.device), tmask], dim=1)
        m = valid[:, None, None, :].bool()
        if causal_text:
            i = torch.arange(n, device=x.device)[:, None]
            j = torch.arange(n, device=x.device)[None, :]
            m = m & ((j < ql) | (j <= i))[None, None]
        img = image_embeds.to(x.dtype)
        for name in self.layer_names:
            x = getattr(self, name)(x, m, img, None, ql, mode=mode)
        return x

    def forward(self, image_embeds, text_ids=None, text_mask=None,
                mode: str = "masked"):
        cfg = self.cfg
        x = self.embed(text_ids)
        b = image_embeds.shape[0]
        if x.shape[0] == 1 and b > 1:
            x = x.expand((b,) + tuple(x.shape[1:]))
        ql = cfg.num_query_tokens
        self_mask = None
        if text_mask is not None:
            full = torch.cat([torch.ones((b, ql), dtype=text_mask.dtype,
                                         device=text_mask.device),
                              text_mask], dim=1)
            self_mask = full[:, None, None, :].bool()
        img = image_embeds.to(x.dtype)
        for name in self.layer_names:
            x = getattr(self, name)(x, self_mask, img, None, ql, mode=mode)
        return x
