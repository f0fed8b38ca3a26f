"""FlanT5 encoder-decoder language tower (port of
``vlm_compression_tpu/models/t5.py``).

v1.1 micro-architecture: RMSNorm (fp32 variance, no bias), gated-GELU FFN
(gelu_tanh(wi_0) ⊙ wi_1 → wo), no attention scaling, relative-position
buckets computed once per stack, untied lm_head.  Names follow the Flax
tree (``encoder/blocks_<i>/self_attn/q``, …).

Attention biases pass to ``attention_core`` at their broadcast shapes:
the relative-position bias (1, h, n, m) and the padding mask (b, 1, 1, m)
stay two separate biases (the JAX package summed them into one (b, h, n, m)
array first; adding a 0 or −1e9 mask before or after the position bias
gives the same softmax).  The KV-cached decode path takes a per-layer
cache dict (``models/kvcache.py``) instead of Flax's mutable collection;
``kv_cache_int8`` / ``kv_cache_per_row`` choose its storage (int8 codes
with absmax scales; a write frontier per row, each row then slicing its own
rows of the position bias, (b, h, n, max_len)).
"""

from __future__ import annotations

import dataclasses
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
    whole,
    Embed,
    SparseLinear,
    gelu,
    run_block,
)
from vlm_compression_tpu_torch.ops.attention import NEG_INF, attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 2048
    d_kv: int = 64
    d_ff: int = 5120
    num_layers: int = 24
    num_decoder_layers: int = 24
    num_heads: int = 32
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    tie_word_embeddings: bool = False
    decoder_start_token_id: int = 0
    pad_token_id: int = 0
    lora_rank: int = 0
    lora_alpha: float = 16.0
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    # decode KV cache storage (models/kvcache.py)
    kv_cache_int8: bool = False
    kv_cache_per_row: bool = False
    use_remat: bool = False   # checkpoint each block (not the cached decode)

    @staticmethod
    def flan_t5_xl(**kw) -> "T5Config":
        return T5Config(**kw)

    @staticmethod
    def flan_t5_xxl(**kw) -> "T5Config":
        d = dict(d_model=4096, d_ff=10240, num_layers=24,
                 num_decoder_layers=24, num_heads=64)
        d.update(kw)
        return T5Config(**d)

    @staticmethod
    def tiny(**kw) -> "T5Config":
        d = dict(vocab_size=96, d_model=16, d_kv=8, d_ff=32, num_layers=2,
                 num_decoder_layers=2, num_heads=2)
        d.update(kw)
        return T5Config(**d)


class RMSNorm(nn.Module):
    """T5LayerNorm: scale-only, fp32 variance, no mean subtraction."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x):
        x32 = x.float()
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + self.eps)
        return (y * self.scale).to(x.dtype)


def relative_position_bucket(rel_pos: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int):
    """HF T5 bucketing (log-spaced beyond num_buckets//2), in fp32."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    denom = np.float32(np.log(max_distance / max_exact))
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / float(denom)
        * (num_buckets - max_exact)).to(rel_pos.dtype)
    val_if_large = val_if_large.clamp(max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


class T5RelPosBias(nn.Module):
    """The (1, heads, q, k) position bias.  The rule ``.*embedding`` puts
    its bucket rows on ``model``; the forward gathers the (32 × heads)
    table whole for the call and, under tensor parallelism, keeps the
    rank's heads."""

    shard_aware = True

    def __init__(self, cfg: T5Config, bidirectional: bool, device=None):
        super().__init__()
        self.cfg = cfg
        self.head_index = None
        self.bidirectional = bidirectional
        self.rel_embedding = nn.Parameter(torch.empty(
            (cfg.relative_attention_num_buckets, cfg.num_heads),
            dtype=torch.float32, device=device))

    def forward(self, q_len: int, k_len: int) -> torch.Tensor:
        cfg = self.cfg
        dev = self.rel_embedding.device
        ctx = torch.arange(q_len, device=dev, dtype=torch.int32)[:, None]
        mem = torch.arange(k_len, device=dev, dtype=torch.int32)[None, :]
        buckets = relative_position_bucket(
            mem - ctx, self.bidirectional, cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        table = whole(self, "rel_embedding")
        if self.head_index is not None:
            table = table[:, self.head_index.to(dev)]
        bias = table[buckets.long()]                     # (q, k, heads)
        return bias.permute(2, 0, 1)[None]               # (1, heads, q, k)


def _sl(cfg: T5Config, in_features, features, device):
    return SparseLinear(in_features, features, False, _dt(cfg.param_dtype),
                        device, lora_rank=cfg.lora_rank,
                        lora_alpha=cfg.lora_alpha)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        for name in ("q", "k", "v"):
            self.add_module(name, _sl(cfg, cfg.d_model, inner, device))
        self.o = _sl(cfg, inner, cfg.d_model, device)
        self.heads = cfg.num_heads

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        """h/t local heads: q, k, v column-parallel, o row-parallel (the
        rule table's own blocks)."""
        cfg = self.cfg
        if cfg.num_heads % size:
            return
        inner = cfg.num_heads * cfg.d_kv
        self.heads = cfg.num_heads // size
        for name in ("q", "k", "v"):
            getattr(self, name).tp = contiguous_plan(COL, group, size, rank,
                                                     inner)
        self.o.tp = contiguous_plan(ROW, group, size, rank, inner)

    def clear_tensor_parallel_(self) -> None:
        self.heads = self.cfg.num_heads

    def project_kv(self, kv, mode="masked"):
        cfg = self.cfg
        b, m, _ = kv.shape
        k = self.k(kv, mode=mode).reshape(b, m, self.heads, cfg.d_kv)
        v = self.v(kv, mode=mode).reshape(b, m, self.heads, cfg.d_kv)
        return k, v

    def forward(self, x, kv=None, position_bias=None, mask=None,
                mode="masked", cache: Optional[dict] = None):
        """``cache`` (decode): for self-attention the layer's k/v buffers
        and write index; for cross-attention the encoder k/v projected
        once when the cache was made."""
        cfg = self.cfg
        b, n, _ = x.shape
        inner = self.heads * cfg.d_kv
        q = self.q(x, mode=mode).reshape(b, n, self.heads, cfg.d_kv)
        if cache is not None and kv is not None:
            k, v = cache["key"], cache["value"]
        else:
            k, v = self.project_kv(kv if kv is not None else x, mode)
        if cache is not None and kv is None:
            k, v, cur = cache_kv(cache, k, v)
            max_len = k.shape[1]
            mask = step_visibility_mask(cur, n, max_len, mask, device=x.device)
            if position_bias is not None and isinstance(cur, torch.Tensor):
                # each row at its own frontier: its own bias rows
                rows = cur[:, None] + torch.arange(n, device=cur.device)
                position_bias = position_bias[0][:, rows].transpose(0, 1) \
                    .contiguous()
            elif position_bias is not None:
                position_bias = position_bias[:, :, cur:cur + n, :]
        # no 1/sqrt(d): T5 folds it into init
        out = attention_core(q, k, v, [position_bias, mask], scale=1.0)
        return self.o(out.reshape(b, n, inner), mode=mode)


class T5FFN(nn.Module):
    """Gated-GELU FFN."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.wi_0 = _sl(cfg, cfg.d_model, cfg.d_ff, device)
        self.wi_1 = _sl(cfg, cfg.d_model, cfg.d_ff, device)
        self.wo = _sl(cfg, cfg.d_ff, cfg.d_model, device)

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        d_ff = self.wo.in_features
        if d_ff % size == 0:
            self.wi_0.tp = contiguous_plan(COL, group, size, rank, d_ff)
            self.wi_1.tp = contiguous_plan(COL, group, size, rank, d_ff)
            self.wo.tp = contiguous_plan(ROW, group, size, rank, d_ff)

    def forward(self, x, mode="masked"):
        gate = gelu(self.wi_0(x, mode=mode), approximate=True)
        return self.wo(gate * self.wi_1(x, mode=mode), mode=mode)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, device=None):
        super().__init__()
        eps = cfg.layer_norm_epsilon
        self.is_decoder = is_decoder
        self.ln_self = RMSNorm(cfg.d_model, eps, device)
        self.self_attn = T5Attention(cfg, device)
        if is_decoder:
            self.ln_cross = RMSNorm(cfg.d_model, eps, device)
            self.cross_attn = T5Attention(cfg, device)
        self.ln_ffn = RMSNorm(cfg.d_model, eps, device)
        self.ffn = T5FFN(cfg, device)

    def forward(self, x, enc_out=None, self_bias=None, self_mask=None,
                cross_mask=None, mode="masked", cache: Optional[dict] = None):
        x = x + self.self_attn(self.ln_self(x), None, self_bias, self_mask,
                               mode=mode,
                               cache=cache["self"] if cache else None)
        if self.is_decoder:
            x = x + self.cross_attn(self.ln_cross(x), enc_out, None,
                                    cross_mask, mode=mode,
                                    cache=cache["cross"] if cache else None)
        return x + self.ffn(self.ln_ffn(x), mode=mode)


def extend_mask(attention_mask):
    """(b, k) 1/0 → additive (b, 1, 1, k) float32."""
    if attention_mask is None:
        return None
    keep = attention_mask[:, None, None, :].bool()
    return torch.where(keep, torch.zeros((), device=keep.device),
                       torch.full((), NEG_INF, device=keep.device))


def causal_mask(q_len: int, k_len: Optional[int] = None, device=None):
    k_len = k_len or q_len
    i = torch.arange(q_len, device=device)[:, None]
    j = torch.arange(k_len, device=device)[None, :]
    return torch.where(j <= i + (k_len - q_len),
                       torch.zeros((), device=device),
                       torch.full((), NEG_INF, device=device))[None, None]


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config, is_decoder: bool, device=None):
        super().__init__()
        self.cfg = cfg
        self.rel_bias = T5RelPosBias(cfg, bidirectional=not is_decoder,
                                     device=device)
        depth = cfg.num_decoder_layers if is_decoder else cfg.num_layers
        self.block_names = [f"blocks_{i}" for i in range(depth)]
        for name in self.block_names:
            self.add_module(name, T5Block(cfg, is_decoder, device))
        self.final_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon, device)

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        h = self.cfg.num_heads
        if h % size == 0:
            self.rel_bias.head_index = torch.arange(rank * h // size,
                                                    (rank + 1) * h // size)

    def clear_tensor_parallel_(self) -> None:
        self.rel_bias.head_index = None


class T5Encoder(_Stack):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__(cfg, is_decoder=False, device=device)

    def forward(self, inputs_embeds, attention_mask=None, mode="masked"):
        x = inputs_embeds
        bias = self.rel_bias(x.shape[1], x.shape[1])
        mask = extend_mask(attention_mask)
        for blk in self.blocks():
            x = run_block(blk, x, None, bias, mask, None, mode=mode,
                          remat=self.cfg.use_remat)
        return self.final_norm(x)


class T5Decoder(_Stack):
    def __init__(self, cfg: T5Config, device=None):
        super().__init__(cfg, is_decoder=True, device=device)

    def forward(self, inputs_embeds, enc_out, dec_mask=None, enc_mask=None,
                mode="masked", cache: Optional[dict] = None):
        """Full sequence (cache None) or one KV-cached step: the cache's
        ``position_bias`` is the full (L, L) bias, row-sliced at the write
        position inside each self-attention."""
        x = inputs_embeds
        n = x.shape[1]
        if cache is not None:
            bias, self_mask = cache["position_bias"], None
        else:
            bias = self.rel_bias(n, n) + causal_mask(n, device=x.device)
            self_mask = extend_mask(dec_mask)
        cmask = extend_mask(enc_mask)
        for i, blk in enumerate(self.blocks()):
            if cache is not None:       # the cached decode: never remat'd
                x = blk(x, enc_out, bias, self_mask, cmask, mode=mode,
                        cache=cache["layers"][i])
            else:
                x = run_block(blk, x, enc_out, bias, self_mask, cmask,
                              mode=mode, remat=self.cfg.use_remat)
        return self.final_norm(x)

    def init_cache(self, enc_out, max_decode_len: int, mode="masked") -> dict:
        """Empty self-attention k/v buffers of length ``max_decode_len`` (in
        the config's int8 / per-row storage) and the cross-attention k/v of
        ``enc_out``, projected once."""
        cfg = self.cfg
        b = enc_out.shape[0]
        layers = []
        for blk in self.blocks():
            k, v = blk.cross_attn.project_kv(enc_out, mode)
            layers.append({
                "self": init_kv_cache(b, max_decode_len, blk.self_attn.heads,
                                      cfg.d_kv, enc_out.dtype,
                                      enc_out.device, cfg.kv_cache_int8,
                                      cfg.kv_cache_per_row),
                "cross": {"key": k, "value": v},
            })
        return {"layers": layers,
                "position_bias": self.rel_bias(max_decode_len,
                                               max_decode_len)}


class T5ForConditionalGeneration(nn.Module):
    """Seq2seq LM head model; forward returns logits (or loss + logits)."""

    def __init__(self, cfg: T5Config, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = _dt(cfg.param_dtype)
        self.shared = Embed(cfg.vocab_size, cfg.d_model, pdt, device)
        self.encoder = T5Encoder(cfg, device)
        self.decoder = T5Decoder(cfg, device)
        if not cfg.tie_word_embeddings:
            self.lm_head = SparseLinear(cfg.d_model, cfg.vocab_size, False, pdt,
                                        device)

    def embed_tokens(self, ids):
        return self.shared(ids).to(_dt(self.cfg.dtype))

    def encode(self, input_ids=None, inputs_embeds=None, attention_mask=None,
               mode="masked"):
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        return self.encoder(inputs_embeds, attention_mask, mode=mode)

    def decode(self, decoder_input_ids, enc_out, dec_mask=None, enc_mask=None,
               mode="masked", cache: Optional[dict] = None):
        x = self.embed_tokens(decoder_input_ids)
        h = self.decoder(x, enc_out, dec_mask, enc_mask, mode=mode,
                         cache=cache)
        if self.cfg.tie_word_embeddings:
            h = h * (self.cfg.d_model ** -0.5)
            logits = h.to(self.shared.embedding.dtype) @ self.shared.embedding.T
        else:
            logits = self.lm_head(h, mode=mode)
        return logits.float()

    def forward(self, input_ids=None, attention_mask=None,
                decoder_input_ids=None, decoder_attention_mask=None,
                inputs_embeds=None, labels=None, mode="masked"):
        if labels is not None and decoder_input_ids is None:
            decoder_input_ids = shift_right(
                labels, self.cfg.decoder_start_token_id, self.cfg.pad_token_id)
            if decoder_attention_mask is None:
                decoder_attention_mask = (labels != -100).to(torch.int32)
        enc = self.encode(input_ids, inputs_embeds, attention_mask, mode=mode)
        logits = self.decode(decoder_input_ids, enc, decoder_attention_mask,
                             attention_mask, mode=mode)
        if labels is None:
            return logits
        return {"loss": cross_entropy_loss(logits, labels), "logits": logits}


def shift_right(labels, decoder_start_token_id=0, pad_token_id=0):
    """HF ``_shift_right``: labels → decoder inputs."""
    start = torch.full(labels.shape[:-1] + (1,), decoder_start_token_id,
                       dtype=labels.dtype, device=labels.device)
    shifted = torch.cat([start, labels[..., :-1]], dim=-1)
    return torch.where(shifted == -100,
                       torch.full_like(shifted, pad_token_id), shifted)


def cross_entropy_loss(logits, labels, ignore_index=-100):
    """Token-mean CE over non-ignored labels."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
    n = valid.sum().clamp(min=1)
    return -(ll * valid).sum() / n
