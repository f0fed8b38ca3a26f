"""GPT-2 dialogue for AVSD (port of
``vlm_compression_tpu/models/gpt_dialogue.py``).

A GPT-2 LM whose input is [projected video features ⊕ token embeddings]:
``video_ff`` (float32) maps each i3d ⊕ vggish feature row to the model
width, the token-type ids (caption / speaker1 / speaker2) embed through the
same ``wte`` table, learned positions run over both, and the causal trunk
(``attention_core`` with the causal flag) spans the video prefix and the
text.  Pre-LN blocks at eps 1e-5 (LayerNorms in float32), a fused
``c_attn``, tanh GELU.  The LM head is the tied product with ``wte`` in
float32 (a plain product, as in the JAX package, which runs it outside any
kernel).  The loss: the shifted token cross entropy over labels ≥ 0, plus,
with video, the mean squared error of ``video_ff_out``'s prediction of the
next feature row.  Built on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.layers import (
    Embed,
    LayerNorm,
    SparseLinear,
    gelu,
)
from vlm_compression_tpu_torch.ops.attention import attention_core


def _dt(name: str) -> torch.dtype:
    return getattr(torch, name)


@dataclasses.dataclass(frozen=True)
class GPTDialogueConfig:
    vocab_size: int = 50264            # gpt2 + dialogue special tokens
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    n_positions: int = 1024
    len_video_ft: int = 4224
    layer_norm_eps: float = 1e-5
    param_dtype: str = "float32"
    dtype: str = "bfloat16"
    lora_rank: int = 0
    lora_alpha: float = 16.0

    @staticmethod
    def base(**kw) -> "GPTDialogueConfig":
        return GPTDialogueConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "GPTDialogueConfig":
        d = dict(vocab_size=64, n_embd=16, n_layer=2, n_head=2,
                 n_positions=64, len_video_ft=8)
        d.update(kw)
        return GPTDialogueConfig(**d)


def _sl(cfg: GPTDialogueConfig, in_features, features, device):
    return SparseLinear(in_features, features,
                        param_dtype=_dt(cfg.param_dtype), device=device,
                        lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha)


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPTDialogueConfig, device=None):
        super().__init__()
        self.cfg = cfg
        e = cfg.n_embd
        self.ln_1 = LayerNorm(e, cfg.layer_norm_eps, device)
        self.c_attn = _sl(cfg, e, 3 * e, device)
        self.c_proj = _sl(cfg, e, e, device)
        self.ln_2 = LayerNorm(e, cfg.layer_norm_eps, device)
        self.mlp_fc = _sl(cfg, e, 4 * e, device)
        self.mlp_proj = _sl(cfg, 4 * e, e, device)

    def forward(self, x, mode="masked"):
        h = self.cfg.n_head
        d = self.cfg.n_embd // h
        b, n, _ = x.shape
        y = self.ln_1(x).to(x.dtype)
        qkv = self.c_attn(y, mode=mode).reshape(b, n, 3, h, d)
        ctx = attention_core(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                             scale=float(d) ** -0.5, causal=True)
        x = x + self.c_proj(ctx.reshape(b, n, h * d), mode=mode)
        y = self.ln_2(x).to(x.dtype)
        hdn = gelu(self.mlp_fc(y, mode=mode), approximate=True)
        return x + self.mlp_proj(hdn, mode=mode)


class GPTDialogue(nn.Module):
    def __init__(self, cfg: GPTDialogueConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        pdt = _dt(cfg.param_dtype)
        self.wte = Embed(cfg.vocab_size, cfg.n_embd, pdt, device)
        self.wpe = Embed(cfg.n_positions, cfg.n_embd, pdt, device)
        self.video_ff = SparseLinear(cfg.len_video_ft, cfg.n_embd,
                                     device=device)
        self.video_ff_out = SparseLinear(cfg.n_embd, cfg.len_video_ft,
                                         device=device)
        self.block_names = [f"h_{i}" for i in range(cfg.n_layer)]
        for name in self.block_names:
            self.add_module(name, GPT2Block(cfg, device))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_eps, device)

    @property
    def device(self) -> torch.device:
        return self.wte.embedding.device

    def blocks(self):
        return [getattr(self, name) for name in self.block_names]

    def trunk(self, input_embs, mode="masked"):
        """Positions added, the blocks, the final norm (float32 out)."""
        n = input_embs.shape[1]
        x = (input_embs + self.wpe.embedding[:n][None]).to(
            _dt(self.cfg.dtype))
        for blk in self.blocks():
            x = blk(x, mode=mode)
        return self.ln_f(x)

    def forward(self, input_ids, video_fts=None, labels=None,
                token_type_ids=None, mode: str = "masked"):
        cfg = self.cfg
        tok = self.wte(input_ids).float()
        if token_type_ids is not None:
            # the segment embeddings share the token embedding table
            tok = tok + self.wte(token_type_ids).float()
        n_vid = 0
        if video_fts is not None:
            vid = self.video_ff(video_fts.float(), mode=mode)
            tok = torch.cat([vid, tok], dim=1)
            n_vid = video_fts.shape[1]
        hidden = self.trunk(tok, mode=mode)
        logits = hidden[:, n_vid:] @ self.wte.embedding.float().T
        out = {"logits": logits}
        if labels is not None:
            lp = torch.log_softmax(logits[:, :-1], dim=-1)
            tgt = labels[:, 1:]
            msk = (tgt >= 0).float()
            nll = -torch.gather(lp, -1, tgt.clamp(
                0, cfg.vocab_size - 1)[..., None].long())[..., 0]
            loss = (nll * msk).sum() / msk.sum().clamp(min=1.0)
            if video_fts is not None:
                vlog = self.video_ff_out(hidden[:, :n_vid], mode=mode)
                vloss = ((vlog[:, :-1] - video_fts[:, 1:].float()) ** 2
                         ).mean()
                loss = loss + vloss
                out["video_loss"] = vloss
            out["loss"] = loss
        return out


GPT_MODELS = {"gpt_dialogue": GPTDialogue}
