"""Plain (timm-style) ViT, the BLIP-1 / ALBEF / CLIP vision tower (port of
``vlm_compression_tpu/models/vit.py``).

ViT-B/16 (or L/16): a CLS token and learned positions, pre-LN blocks with
a fused qkv (biases on all three), exact GELU, LayerNorms in float32 at
eps 1e-6 and a final norm.  Images are (b, h, w, 3); the patch embedding
keeps the Flax conv kernel layout (p, p, 3, embed) and runs as a patchify +
float32 matmul (Flax's stride-p conv with its default SAME padding).
Every linear is a ``SparseLinear``; names follow the Flax tree
(``blocks_<i>/attn/qkv``, ``blocks_<i>/fc1``, ``norm``, …).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vlm_compression_tpu_torch.models.layers import (
    LayerNorm,
    SparseLinear,
    gelu,
)
from vlm_compression_tpu_torch.ops.attention import attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    param_dtype: str = "float32"
    dtype: str = "bfloat16"
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @staticmethod
    def base(**kw) -> "ViTConfig":
        return ViTConfig(**kw)

    @staticmethod
    def large(**kw) -> "ViTConfig":
        d = dict(embed_dim=1024, depth=24, num_heads=16)
        d.update(kw)
        return ViTConfig(**d)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        d = dict(img_size=28, patch_size=14, embed_dim=16, depth=2,
                 num_heads=2)
        d.update(kw)
        return ViTConfig(**d)


def _sl(cfg: ViTConfig, in_features, features, device):
    return SparseLinear(in_features, features,
                        param_dtype=_dt(cfg.param_dtype), device=device,
                        lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)


class ViTAttention(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.qkv = _sl(cfg, cfg.embed_dim, 3 * cfg.embed_dim, device)
        self.proj = _sl(cfg, cfg.embed_dim, cfg.embed_dim, device)

    def forward(self, x, mode="masked"):
        h = self.cfg.num_heads
        d = self.cfg.embed_dim // h
        b, n, _ = x.shape
        qkv = self.qkv(x, mode=mode).reshape(b, n, 3, h, d)
        out = attention_core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             scale=float(d) ** -0.5)
        return self.proj(out.reshape(b, n, h * d), mode=mode)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, device)
        self.attn = ViTAttention(cfg, device)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, device)
        self.fc1 = _sl(cfg, cfg.embed_dim, hidden, device)
        self.fc2 = _sl(cfg, hidden, cfg.embed_dim, device)

    def forward(self, x, mode="masked"):
        x = x + self.attn(self.norm1(x).to(x.dtype), mode=mode)
        h = gelu(self.fc1(self.norm2(x).to(x.dtype), mode=mode))
        return x + self.fc2(h, mode=mode)


def patchify_same(images: torch.Tensor, p: int) -> torch.Tensor:
    """(b, h, w, c) → (b, ⌈h/p⌉·⌈w/p⌉, p·p·c): the patches a stride-p,
    p × p conv with SAME padding reads (zeros split as XLA splits them)."""
    b, hh, ww, c = images.shape
    gh, gw = -(-hh // p), -(-ww // p)
    ph, pw = gh * p - hh, gw * p - ww
    if ph or pw:
        images = nn.functional.pad(
            images, (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
    x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, p * p * c)


class ViT(nn.Module):
    """forward(images) → (b, 1 + patches, embed_dim), CLS at position 0,
    after the final norm, in the compute dtype."""

    def __init__(self, cfg: ViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt, p = _dt(cfg.param_dtype), cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = nn.Parameter(torch.empty(
            (p, p, 3, cfg.embed_dim), dtype=pdt, device=device))
        self.patch_embed.bias = nn.Parameter(torch.zeros(
            cfg.embed_dim, dtype=pdt, device=device))
        self.cls_token = nn.Parameter(torch.zeros(
            (1, 1, cfg.embed_dim), dtype=pdt, device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            (1, cfg.num_patches + 1, cfg.embed_dim), dtype=pdt,
            device=device))
        self.block_names = [f"blocks_{i}" for i in range(cfg.depth)]
        for name in self.block_names:
            self.add_module(name, ViTBlock(cfg, device))
        self.norm = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, device)

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Patchify + cls + positions, in float32 (the conv's input and
        parameter dtype), then cast: the input to block 0."""
        cfg = self.cfg
        x = patchify_same(images.float(), cfg.patch_size)
        kern = self.patch_embed.kernel.float().reshape(x.shape[-1], -1)
        x = x @ kern + self.patch_embed.bias.float()
        cls = self.cls_token.float().expand(x.shape[0], 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.float()
        return x.to(_dt(cfg.dtype))

    def forward(self, images, mode: str = "masked"):
        x = self.embed(images)
        for blk in self.blocks():
            x = blk(x, mode)
        return self.norm(x).to(_dt(self.cfg.dtype))
