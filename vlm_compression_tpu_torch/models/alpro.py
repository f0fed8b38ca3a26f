"""ALPRO over video: the TimeSformer tower and the retrieval and QA heads
(port of ``vlm_compression_tpu/models/alpro.py``).

TimeSformer-B/16 with divided space-time attention, per block: (1)
temporal attention over each patch position's frames (CLS left out), its
output through ``temporal_fc`` and added back; (2) spatial attention over
[CLS ⊕ frame] for each frame, CLS repeated per frame and its outputs
averaged over the frames; (3) the MLP with exact GELU.  LayerNorms in
float32 at eps 1e-6, every linear a ``SparseLinear`` with its bias, every
attention through ``attention_core`` (no bias).  The patch embedding is
the HWIO conv of ``models/vit.py`` (patchify + float32 product) over the
b·T frames, then the positions (197 at 224), ``time_embed[:, :T]`` and the
CLS token.

ALPRO pairs it with MED (``fusion_start`` 6): the unimodal text runs the
layers [0, fusion_start), ``fuse`` the rest from those hidden states with
cross-attention to the video tokens.  ``AlproRetrieval``: in-batch VTC +
hard-negative VTM (the float32 ``itm_head``); ``AlproQA``: the fused CLS
through a float32 ``classifier``.  Each builds only the heads its JAX
init creates (``HEADS``, as in ``models/blip1.py``).  Built on the card
unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.albef import SplitFusion
from vlm_compression_tpu_torch.models.blip1 import (
    TEMP_INIT,
    _itc_loss,
    class_loss,
    clamp_temp,
    hard_negatives,
    itm_loss,
    unit,
)
from vlm_compression_tpu_torch.models.layers import (
    LayerNorm,
    SparseLinear,
    gelu,
)
from vlm_compression_tpu_torch.models.med import MedBert, MedConfig
from vlm_compression_tpu_torch.models.vit import patchify_same
from vlm_compression_tpu_torch.ops.attention import attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    num_frames: int = 8
    layer_norm_eps: float = 1e-6
    param_dtype: str = "float32"
    dtype: str = "bfloat16"
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @staticmethod
    def tiny(**kw) -> "TimeSformerConfig":
        d = dict(img_size=28, patch_size=14, embed_dim=16, depth=2,
                 num_heads=2, num_frames=2)
        d.update(kw)
        return TimeSformerConfig(**d)


def _sl(cfg: TimeSformerConfig, in_features, features, device):
    return SparseLinear(in_features, features,
                        param_dtype=_dt(cfg.param_dtype), device=device,
                        lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)


class TimeSformerBlock(nn.Module):
    def __init__(self, cfg: TimeSformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e, eps = cfg.embed_dim, cfg.layer_norm_eps
        self.temporal_norm1 = LayerNorm(e, eps, device)
        for name in ("t_q", "t_k", "t_v", "t_proj", "temporal_fc",
                     "q", "k", "v", "proj"):
            self.add_module(name, _sl(cfg, e, e, device))
        self.norm1 = LayerNorm(e, eps, device)
        self.norm2 = LayerNorm(e, eps, device)
        hidden = int(e * cfg.mlp_ratio)
        self.fc1 = _sl(cfg, e, hidden, device)
        self.fc2 = _sl(cfg, hidden, e, device)

    def _mha(self, x, q, k, v, proj, mode):
        h = self.cfg.num_heads
        d = self.cfg.embed_dim // h
        b, n, _ = x.shape
        out = attention_core(q(x, mode=mode).reshape(b, n, h, d),
                             k(x, mode=mode).reshape(b, n, h, d),
                             v(x, mode=mode).reshape(b, n, h, d),
                             scale=float(d) ** -0.5)
        return proj(out.reshape(b, n, h * d), mode=mode)

    def forward(self, x, n_frames: int, mode="masked"):
        """x: (b, 1 + T·P, d), CLS first."""
        b, n, dim = x.shape
        p = (n - 1) // n_frames
        # (1) temporal attention at each patch position (no CLS)
        xt = x[:, 1:].reshape(b, n_frames, p, dim).transpose(1, 2) \
            .reshape(b * p, n_frames, dim)
        y = self.temporal_norm1(xt).to(x.dtype)
        t_out = self.temporal_fc(
            self._mha(y, self.t_q, self.t_k, self.t_v, self.t_proj, mode),
            mode=mode)
        xt = (xt + t_out).reshape(b, p, n_frames, dim).transpose(1, 2) \
            .reshape(b, n_frames * p, dim)
        x = torch.cat([x[:, :1], xt], dim=1)
        # (2) spatial attention over [CLS ⊕ frame], CLS repeated per frame
        y = self.norm1(x).to(x.dtype)
        frame = torch.cat([y[:, :1].repeat_interleave(n_frames, dim=0),
                           y[:, 1:].reshape(b * n_frames, p, dim)], dim=1)
        s_out = self._mha(frame, self.q, self.k, self.v, self.proj, mode)
        new_cls = s_out[:, 0].reshape(b, n_frames, dim).mean(1, keepdim=True)
        x = x + torch.cat([new_cls, s_out[:, 1:].reshape(b, n_frames * p,
                                                         dim)], dim=1)
        # (3) MLP
        y = self.norm2(x).to(x.dtype)
        return x + self.fc2(gelu(self.fc1(y, mode=mode)), mode=mode)


class TimeSformer(nn.Module):
    """forward(video (b, T, H, W, 3)) → (b, 1 + T·patches, embed_dim) after
    the final norm, in the compute dtype."""

    def __init__(self, cfg: TimeSformerConfig, device=None):
        super().__init__()
        self.cfg = cfg
        pdt, p, e = _dt(cfg.param_dtype), cfg.patch_size, cfg.embed_dim
        self.patch_embed = nn.Module()
        self.patch_embed.kernel = nn.Parameter(torch.empty(
            (p, p, 3, e), dtype=pdt, device=device))
        self.patch_embed.bias = nn.Parameter(torch.zeros(
            e, dtype=pdt, device=device))
        self.cls_token = nn.Parameter(torch.zeros((1, 1, e), dtype=pdt,
                                                  device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            (1, cfg.num_patches + 1, e), dtype=pdt, device=device))
        self.time_embed = nn.Parameter(torch.empty(
            (1, cfg.num_frames, e), dtype=pdt, device=device))
        self.block_names = [f"blocks_{i}" for i in range(cfg.depth)]
        for name in self.block_names:
            self.add_module(name, TimeSformerBlock(cfg, device))
        self.norm = LayerNorm(e, cfg.layer_norm_eps, device)

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def embed(self, video: torch.Tensor) -> torch.Tensor:
        """Patches of the b·T frames, positions, ``time_embed[:, :T]`` and
        CLS in float32 (the conv's input and parameter dtype), then cast:
        the input to block 0.  ``time_embed`` has ``num_frames`` rows: a
        clip of more frames raises, as the JAX tower's broadcast does (the
        QA yamls' ``n_frms`` 16 against the factory's 8 frames)."""
        cfg = self.cfg
        b, t = video.shape[:2]
        if t > cfg.num_frames:
            raise ValueError(
                f"a clip of {t} frames, but time_embed holds "
                f"{cfg.num_frames}: the JAX tower fails to broadcast there "
                f"too (set the processor's n_frms to at most "
                f"{cfg.num_frames})")
        frames = video.float().reshape((b * t,) + tuple(video.shape[2:]))
        x = patchify_same(frames, cfg.patch_size)
        kern = self.patch_embed.kernel.float().reshape(x.shape[-1], -1)
        x = x @ kern + self.patch_embed.bias.float()
        p = x.shape[1]
        pos = self.pos_embed.float()
        spat = (x.reshape(b, t, p, cfg.embed_dim) + pos[:, None, 1:]
                + self.time_embed.float()[:, :t, None]).reshape(
                    b, t * p, cfg.embed_dim)
        cls = (self.cls_token.float() + pos[:, :1]).expand(
            b, 1, cfg.embed_dim)
        return torch.cat([cls, spat], dim=1).to(_dt(cfg.dtype))

    def forward(self, video, mode: str = "masked"):
        x = self.embed(video)
        t = video.shape[1]
        for blk in self.blocks():
            x = blk(x, t, mode=mode)
        return self.norm(x).to(_dt(self.cfg.dtype))


@dataclasses.dataclass(frozen=True)
class AlproConfig:
    timesformer: TimeSformerConfig = dataclasses.field(
        default_factory=TimeSformerConfig)
    med: MedConfig = dataclasses.field(
        default_factory=lambda: MedConfig(fusion_start=6))
    embed_dim: int = 256
    num_classes: int = 2

    @staticmethod
    def base(**kw) -> "AlproConfig":
        return AlproConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "AlproConfig":
        d = dict(timesformer=TimeSformerConfig.tiny(),
                 med=MedConfig.tiny(fusion_start=1), embed_dim=8)
        d.update(kw)
        return AlproConfig(**d)


class AlproBase(SplitFusion, nn.Module):
    """TimeSformer + MED split at ``fusion_start`` as ALBEF's, the heads
    named in ``HEADS`` ("itc": ``vision_proj`` / ``text_proj``; "itm":
    ``itm_head``; "cls": ``classifier``) and ``temp``."""

    HEADS = ("itc", "itm")

    def __init__(self, cfg: AlproConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        hd, e = cfg.med.hidden_size, cfg.timesformer.embed_dim
        self.visual_encoder = TimeSformer(cfg.timesformer, device)
        self.text_encoder = MedBert(cfg.med, device=device)
        if "itc" in self.HEADS:
            self.vision_proj = SparseLinear(e, cfg.embed_dim, device=device)
            self.text_proj = SparseLinear(hd, cfg.embed_dim, device=device)
        if "itm" in self.HEADS:
            self.itm_head = SparseLinear(hd, 2, device=device)
        if "cls" in self.HEADS:
            self.classifier = SparseLinear(hd, cfg.num_classes,
                                           device=device)
        self.temp = nn.Parameter(torch.tensor(TEMP_INIT, dtype=torch.float32,
                                              device=device))

    @property
    def device(self) -> torch.device:
        return self.temp.device

    def encode_video(self, video, mode="masked"):
        return self.visual_encoder(video, mode=mode)

    def video_feature(self, vid, mode="masked"):
        """Unit-norm VTC feature of the video's CLS position."""
        return unit(self.vision_proj(vid[:, 0].float(), mode=mode))

    def text_feature(self, txt, mode="masked"):
        """Unit-norm VTC feature of the text's CLS position."""
        return unit(self.text_proj(txt[:, 0].float(), mode=mode))

    def itm_logits(self, text_hidden, mask, video_embeds, mode="masked"):
        """VTM logits of the fused CLS (the retrieval rerank's)."""
        fused = self.fuse(text_hidden, mask, video_embeds, mode=mode)
        return self.itm_head(fused[:, 0].float(), mode=mode)

    def vtc_feats(self, video, ids, mask, mode="masked"):
        vid = self.encode_video(video, mode=mode)
        txt = self.unimodal_text(ids, mask, mode=mode)
        return (self.video_feature(vid, mode), self.text_feature(txt, mode),
                vid, txt)

    # the names the zoo's shared retrieval code calls
    encode_image = encode_video
    image_feature = video_feature


class AlproRetrieval(AlproBase):
    """In-batch VTC + hard-negative VTM."""

    def forward(self, video, input_ids, attention_mask=None,
                mode: str = "masked"):
        fv, ft, vid, txt = self.vtc_feats(video, input_ids, attention_mask,
                                          mode=mode)
        loss_vtc, sim_v2t, _ = _itc_loss(fv, ft, clamp_temp(self.temp))
        neg = hard_negatives(sim_v2t)
        logits = torch.cat([
            self.itm_logits(txt, attention_mask, vid, mode=mode),
            self.itm_logits(txt[neg], attention_mask[neg], vid, mode=mode),
            self.itm_logits(txt, attention_mask, vid[neg], mode=mode)])
        loss_vtm = itm_loss(logits, fv.shape[0])
        return {"loss": loss_vtc + loss_vtm, "loss_vtc": loss_vtc,
                "loss_vtm": loss_vtm}


class AlproQA(AlproBase):
    """The fused CLS through the answer classifier."""

    HEADS = ("cls",)

    def forward(self, video, input_ids, attention_mask=None, labels=None,
                mode: str = "masked"):
        vid = self.encode_video(video, mode=mode)
        txt = self.unimodal_text(input_ids, attention_mask, mode=mode)
        fused = self.fuse(txt, attention_mask, vid, mode=mode)
        logits = self.classifier(fused[:, 0].float(), mode=mode)
        out = {"logits": logits, "predictions": torch.argmax(logits, -1)}
        if labels is not None:
            out["loss"] = class_loss(logits, labels)
        return out


ALPRO_MODELS = {"alpro_retrieval": AlproRetrieval, "alpro_qa": AlproQA}
