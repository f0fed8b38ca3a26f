"""EVA ViT-g vision tower (port of ``vlm_compression_tpu/models/eva_vit.py``).

39 pre-LN blocks, embed 1408, 16 heads × 88 head-dim, MLP 6144, patch 14,
fused qkv with separate q/v biases (k bias fixed at zero), no final norm
in the BLIP-2 path; ``use_remat`` checkpoints every block.  Images are
(b, h, w, 3) as in the JAX package; the patch embedding keeps the Flax
conv kernel layout (p, p, 3, embed) and runs as a patchify + matmul (a
stride-p VALID conv).  Submodule and
parameter names follow the Flax tree (``blocks_<i>``, ``attn/qkv``, …).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from vlm_compression_tpu_torch.models.layers import (
    COL,
    ROW,
    LayerNorm,
    SparseLinear,
    TPPlan,
    contiguous_plan,
    whole,
    gelu,
    run_block,
)
from vlm_compression_tpu_torch.ops.attention import attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class EvaViTConfig:
    img_size: int = 224
    patch_size: int = 14
    embed_dim: int = 1408
    depth: int = 39
    num_heads: int = 16
    mlp_hidden_dim: int = 6144          # int(1408 * 4.3637)
    layer_norm_eps: float = 1e-6
    lora_rank: int = 0                  # rank for all target linears (V tower)
    lora_alpha: float = 16.0
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    use_remat: bool = False             # checkpoint every block (training)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @staticmethod
    def eva_clip_g(**kw) -> "EvaViTConfig":
        return EvaViTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "EvaViTConfig":
        d = dict(img_size=28, patch_size=14, embed_dim=16, depth=2,
                 num_heads=2, mlp_hidden_dim=32)
        d.update(kw)
        return EvaViTConfig(**d)


def _sl(cfg: EvaViTConfig, in_features, features, use_bias=True,
        device=None):
    return SparseLinear(in_features, features, use_bias,
                        param_dtype=_dt(cfg.param_dtype), device=device,
                        lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)


class EvaAttention(nn.Module):
    def __init__(self, cfg: EvaViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt, dim = _dt(cfg.param_dtype), cfg.embed_dim
        self.qkv = _sl(cfg, dim, 3 * dim, use_bias=False, device=device)
        self.q_bias = nn.Parameter(torch.zeros(dim, dtype=pdt, device=device))
        self.v_bias = nn.Parameter(torch.zeros(dim, dtype=pdt, device=device))
        self.proj = _sl(cfg, dim, dim, device=device)
        self.heads, self.head_cols = cfg.num_heads, None

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        """Heads [rank·h/t, (rank+1)·h/t): the fused qkv is
        column-parallel over those heads' q, k and v columns — not the
        rule table's contiguous third-and-a-half, so the forward gathers
        the stored halves for the call and indexes them — and proj is
        row-parallel over the same features (its stored block)."""
        cfg = self.cfg
        if cfg.num_heads % size:
            return
        dim = cfg.embed_dim
        self.heads = cfg.num_heads // size
        cols = torch.arange(rank * dim // size, (rank + 1) * dim // size)
        self.head_cols = cols
        self.qkv.tp = TPPlan(COL, group, size, rank,
                             torch.cat([cols, cols + dim, cols + 2 * dim]))
        self.proj.tp = TPPlan(ROW, group, size, rank, cols)

    def clear_tensor_parallel_(self) -> None:
        self.heads, self.head_cols = self.cfg.num_heads, None

    def forward(self, x, mode="masked"):
        cfg = self.cfg
        b, n, _ = x.shape
        head_dim = cfg.embed_dim // cfg.num_heads
        qkv = self.qkv(x, mode=mode)
        # fused projection, bias only on q and v
        qb, vb = self.q_bias, self.v_bias
        if self.head_cols is not None:
            qb = qb[self.head_cols.to(qb.device)]
            vb = vb[self.head_cols.to(vb.device)]
        bias = torch.cat([qb, torch.zeros_like(qb), vb]).to(qkv.dtype)
        qkv = (qkv + bias).reshape(b, n, 3, self.heads, head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]   # strided views
        out = attention_core(q, k, v, scale=head_dim ** -0.5)
        return self.proj(out.reshape(b, n, self.heads * head_dim), mode=mode)


class EvaMlp(nn.Module):
    def __init__(self, cfg: EvaViTConfig, device=None):
        super().__init__()
        self.fc1 = _sl(cfg, cfg.embed_dim, cfg.mlp_hidden_dim, device=device)
        self.fc2 = _sl(cfg, cfg.mlp_hidden_dim, cfg.embed_dim, device=device)

    def tensor_parallel_(self, group, size: int, rank: int) -> None:
        hidden = self.fc1.features
        if hidden % size == 0:
            self.fc1.tp = contiguous_plan(COL, group, size, rank, hidden)
            self.fc2.tp = contiguous_plan(ROW, group, size, rank, hidden)

    def forward(self, x, mode="masked"):
        return self.fc2(gelu(self.fc1(x, mode=mode)), mode=mode)


class EvaBlock(nn.Module):
    def __init__(self, cfg: EvaViTConfig, device=None):
        super().__init__()
        self.norm1 = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, device)
        self.attn = EvaAttention(cfg, device)
        self.norm2 = LayerNorm(cfg.embed_dim, cfg.layer_norm_eps, device)
        self.mlp = EvaMlp(cfg, device)

    def forward(self, x, mode="masked"):
        x = x + self.attn(self.norm1(x).to(x.dtype), mode=mode)
        return x + self.mlp(self.norm2(x).to(x.dtype), mode=mode)


class EvaViT(nn.Module):
    """Vision tower: forward(images (b,h,w,3)) → (b, 1+patches, embed).

    ``embed`` is the stem the calibration engine runs alone; blocks are
    addressable as ``blocks_<i>``."""

    def __init__(self, cfg: EvaViTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt, p = _dt(cfg.param_dtype), cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.shard_aware = True     # FSDP's rule shards it
        self.patch_embed.kernel = nn.Parameter(torch.empty(
            (p, p, 3, cfg.embed_dim), dtype=pdt, device=device))
        self.patch_embed.bias = nn.Parameter(torch.zeros(
            cfg.embed_dim, dtype=pdt, device=device))
        self.cls_token = nn.Parameter(torch.empty(
            (1, 1, cfg.embed_dim), dtype=pdt, device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            (1, cfg.num_patches + 1, cfg.embed_dim), dtype=pdt,
            device=device))
        self.block_names = [f"blocks_{i}" for i in range(cfg.depth)]
        for name in self.block_names:
            self.add_module(name, EvaBlock(cfg, device))

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """Patchify + cls + positions: the input to block 0."""
        cfg = self.cfg
        dt = _dt(cfg.dtype)
        p = cfg.patch_size
        b, hh, ww, c = images.shape
        gh, gw = hh // p, ww // p
        x = images[:, :gh * p, :gw * p].to(dt)
        x = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        kern = whole(self.patch_embed, "kernel").to(dt).reshape(p * p * c,
                                                                -1)
        x = torch.matmul(x.float(), kern.float()).to(dt) \
            + self.patch_embed.bias.to(dt)
        cls = self.cls_token.to(dt).expand(b, 1, cfg.embed_dim)
        x = torch.cat([cls, x], dim=1)
        return x + self.pos_embed.to(dt)

    def forward(self, images, mode: str = "masked"):
        x = self.embed(images)
        for name in self.block_names:
            x = run_block(getattr(self, name), x, mode,
                          remat=self.cfg.use_remat)
        return x   # BLIP-2 path: no final norm


def _bicubic_resize_axis(x, out_size: int, axis: int):
    """Cubic-convolution resample along one axis, matching torch's
    ``F.interpolate(mode="bicubic", align_corners=False)``: A = −0.75,
    source index (i + 0.5)·scale − 0.5, border-replicated taps."""
    x = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    in_size = x.shape[0]
    if in_size == out_size:
        return np.moveaxis(x, 0, axis)
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    i0 = np.floor(src).astype(np.int64)
    t = src - i0
    a = -0.75

    def cc1(u):
        return (a + 2) * u ** 3 - (a + 3) * u ** 2 + 1

    def cc2(u):
        return a * u ** 3 - 5 * a * u ** 2 + 8 * a * u - 4 * a

    w = np.stack([cc2(1 + t), cc1(t), cc1(1 - t), cc2(2 - t)])
    out = np.zeros((out_size,) + x.shape[1:], np.float64)
    for tap in range(4):
        idx = np.clip(i0 + tap - 1, 0, in_size - 1)
        out += w[tap].reshape((-1,) + (1,) * (x.ndim - 1)) * x[idx]
    return np.moveaxis(out, 0, axis)


def interpolate_pos_embed(pos_embed: torch.Tensor, num_patches: int
                          ) -> torch.Tensor:
    """Resize a (1, 1+old_patches, dim) position table to a new patch count
    (keep the cls slot, bicubic-resize the square patch grid; host-side
    numpy, fp32 grid)."""
    old = pos_embed.shape[1] - 1
    if old == num_patches:
        return pos_embed
    dim = pos_embed.shape[-1]
    cls_tok, grid = pos_embed[:, :1], pos_embed[:, 1:]
    g0, g1 = int(math.sqrt(old)), int(math.sqrt(num_patches))
    if g0 * g0 != old or g1 * g1 != num_patches:
        raise ValueError(f"non-square patch grids: {old} -> {num_patches}")
    grid = grid.detach().float().cpu().numpy().reshape(1, g0, g0, dim)
    grid = _bicubic_resize_axis(grid, g1, axis=1)
    grid = _bicubic_resize_axis(grid, g1, axis=2)
    grid = torch.tensor(grid.reshape(1, g1 * g1, dim).astype(np.float32),
                        device=pos_embed.device)
    return torch.cat([cls_tok, grid.to(pos_embed.dtype)], dim=1)
