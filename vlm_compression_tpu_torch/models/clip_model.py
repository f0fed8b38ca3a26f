"""CLIP and EVA-CLIP, the legacy zoo's dual encoders (port of
``vlm_compression_tpu/models/clip_model.py``).

A vision tower with a bias-free float32 ``visual_projection`` of its CLS
position, and a causal text transformer (pre-LN at eps 1e-5, a
tanh-approximate GELU) pooled at the end-of-text token (the argmax of the
ids) through a bias-free float32 ``text_projection``; a learned
``logit_scale``.  ``Clip`` (archs ``clip``, ``clip_feature_extractor``)
takes the plain ViT, ``EvaClip`` (``eva_clip``,
``eva_clip_feature_extractor``) the port's EVA ViT-g.  Retrieval ranks
by the features alone: the family has no ITM head.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.blip1 import class_loss, unit
from vlm_compression_tpu_torch.models.eva_vit import EvaViT, EvaViTConfig
from vlm_compression_tpu_torch.models.layers import (
    Embed,
    LayerNorm,
    SparseLinear,
    gelu,
)
from vlm_compression_tpu_torch.models.vit import ViT, ViTConfig
from vlm_compression_tpu_torch.ops.attention import attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    context_length: int = 77
    layer_norm_eps: float = 1e-5
    param_dtype: str = "float32"
    dtype: str = "bfloat16"
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @staticmethod
    def tiny(**kw) -> "ClipTextConfig":
        d = dict(vocab_size=64, width=16, layers=2, heads=2,
                 context_length=16)
        d.update(kw)
        return ClipTextConfig(**d)


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    text: ClipTextConfig = dataclasses.field(default_factory=ClipTextConfig)
    embed_dim: int = 512
    use_eva: bool = False
    eva: Optional[EvaViTConfig] = None

    @staticmethod
    def base(**kw) -> "ClipConfig":
        return ClipConfig(**kw)

    @staticmethod
    def eva_clip_g(**kw) -> "ClipConfig":
        d = dict(use_eva=True, eva=EvaViTConfig.eva_clip_g(), embed_dim=1024)
        d.update(kw)
        return ClipConfig(**d)

    @staticmethod
    def tiny(**kw) -> "ClipConfig":
        d = dict(vit=ViTConfig.tiny(), text=ClipTextConfig.tiny(),
                 embed_dim=8)
        d.update(kw)
        return ClipConfig(**d)

    @staticmethod
    def tiny_eva(**kw) -> "ClipConfig":
        d = dict(use_eva=True, eva=EvaViTConfig.tiny(), vit=ViTConfig.tiny(),
                 text=ClipTextConfig.tiny(), embed_dim=8)
        d.update(kw)
        return ClipConfig(**d)


def _sl(cfg: ClipTextConfig, in_features, features, device, use_bias=True):
    return SparseLinear(in_features, features, use_bias,
                        param_dtype=_dt(cfg.param_dtype), device=device,
                        lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)


class ClipTextBlock(nn.Module):
    def __init__(self, cfg: ClipTextConfig, device=None):
        super().__init__()
        self.cfg = cfg
        w, eps = cfg.width, cfg.layer_norm_eps
        self.ln_1 = LayerNorm(w, eps, device)
        self.qkv = _sl(cfg, w, 3 * w, device)
        self.proj = _sl(cfg, w, w, device)
        self.ln_2 = LayerNorm(w, eps, device)
        self.fc = _sl(cfg, w, 4 * w, device)
        self.c_proj = _sl(cfg, 4 * w, w, device)

    def forward(self, x, mode="masked"):
        h = self.cfg.heads
        d = self.cfg.width // h
        b, n, _ = x.shape
        y = self.ln_1(x).to(x.dtype)
        qkv = self.qkv(y, mode=mode).reshape(b, n, 3, h, d)
        ctx = attention_core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             scale=float(d) ** -0.5, causal=True)
        x = x + self.proj(ctx.reshape(b, n, h * d), mode=mode)
        y = self.ln_2(x).to(x.dtype)
        hdn = gelu(self.fc(y, mode=mode), approximate=True)
        return x + self.c_proj(hdn, mode=mode)


class ClipTextEncoder(nn.Module):
    """ids (b, n) → the float32 projection (b, embed_dim) of the
    end-of-text position (the highest id, as in OpenCLIP)."""

    def __init__(self, cfg: ClipTextConfig, embed_dim: int, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = _dt(cfg.param_dtype)
        self.token_embedding = Embed(cfg.vocab_size, cfg.width, pdt, device)
        self.positional_embedding = nn.Parameter(torch.empty(
            (cfg.context_length, cfg.width), dtype=pdt, device=device))
        self.block_names = [f"resblocks_{i}" for i in range(cfg.layers)]
        for name in self.block_names:
            self.add_module(name, ClipTextBlock(cfg, device))
        self.ln_final = LayerNorm(cfg.width, cfg.layer_norm_eps, device)
        self.text_projection = _sl(cfg, cfg.width, embed_dim, device,
                                   use_bias=False)

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def forward(self, text_ids, mode="masked"):
        n = text_ids.shape[1]
        x = (self.token_embedding(text_ids)
             + self.positional_embedding[:n][None]).to(_dt(self.cfg.dtype))
        for blk in self.blocks():
            x = blk(x, mode=mode)
        x = self.ln_final(x)
        eot = torch.argmax(text_ids, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.text_projection(pooled.float(), mode=mode)


class Clip(nn.Module):
    """forward(image, input_ids) → the symmetric InfoNCE loss, the scaled
    logits and both unit-norm features; ``extract_features`` the
    features."""

    def __init__(self, cfg: ClipConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        if cfg.use_eva:
            self.visual = EvaViT(cfg.eva, device)
            width = cfg.eva.embed_dim
        else:
            self.visual = ViT(cfg.vit, device)
            width = cfg.vit.embed_dim
        self.visual_projection = SparseLinear(width, cfg.embed_dim, False,
                                              device=device)
        self.text = ClipTextEncoder(cfg.text, cfg.embed_dim, device)
        self.logit_scale = nn.Parameter(torch.tensor(
            math.log(1 / 0.07), dtype=torch.float32, device=device))

    @property
    def device(self) -> torch.device:
        return self.logit_scale.device

    @property
    def image_size(self) -> int:
        return (self.cfg.eva if self.cfg.use_eva else self.cfg.vit).img_size

    def encode_image(self, image, mode="masked"):
        feats = self.visual(image, mode=mode)
        return unit(self.visual_projection(feats[:, 0].float(), mode=mode))

    def encode_text(self, text_ids, mode="masked"):
        return unit(self.text(text_ids, mode=mode))

    def forward(self, image, input_ids, attention_mask=None,
                mode: str = "masked"):
        fi = self.encode_image(image, mode=mode)
        ft = self.encode_text(input_ids, mode=mode)
        scale = torch.exp(self.logit_scale.clamp(max=math.log(100.0)))
        logits = scale * fi @ ft.T
        labels = torch.arange(logits.shape[0], device=logits.device)
        loss = 0.5 * (class_loss(logits, labels)
                      + class_loss(logits.T, labels))
        return {"loss": loss, "logits": logits,
                "image_features": fi, "text_features": ft}

    def extract_features(self, image=None, input_ids=None,
                         mode: str = "masked"):
        out = {}
        if image is not None:
            out["image_features"] = self.encode_image(image, mode=mode)
        if input_ids is not None:
            out["text_features"] = self.encode_text(input_ids, mode=mode)
        return out


class EvaClip(Clip):
    """CLIP with the EVA ViT-g vision tower."""


CLIP_MODELS = {"clip": Clip, "clip_feature_extractor": Clip,
               "eva_clip": EvaClip, "eva_clip_feature_extractor": EvaClip}
