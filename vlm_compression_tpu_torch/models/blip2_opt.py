"""BLIP-2 OPT — the non-instruct decoder-only composition (port of
``vlm_compression_tpu/models/blip2_opt.py``).

ViT → ln_vision → Q-Former (queries only, no instruction text) → opt_proj
(fp32, dense) → prepended to the OPT token embeddings.  The prompt tokens
are part of ``text_input_ids``; ``labels`` carry -100 where no target is,
and the query positions never carry one.  ``generate_opt`` primes the OPT
KV cache with [image prefix ⊕ left-padded prompt minus its last token] and
starts the decode from that last token: beam, greedy / nucleus or
speculative, the decode of ``generate_vicuna`` (``decode_after_prefix``).

The JAX factory builds no ``blip2_opt`` model; neither does the port's:
build it from ``Blip2OPTConfig`` directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
    decode_after_prefix,
    prefix_inputs,
)
from vlm_compression_tpu_torch.models.eva_vit import EvaViT, EvaViTConfig
from vlm_compression_tpu_torch.models.generation import GenerationConfig
from vlm_compression_tpu_torch.models.layers import LayerNorm, SparseLinear
from vlm_compression_tpu_torch.models.opt import OPTConfig, OPTForCausalLM
from vlm_compression_tpu_torch.models.qformer import QFormer, QFormerConfig
from vlm_compression_tpu_torch.models.t5 import cross_entropy_loss


@dataclasses.dataclass(frozen=True)
class Blip2OPTConfig:
    vit: EvaViTConfig = dataclasses.field(default_factory=EvaViTConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    opt: OPTConfig = dataclasses.field(default_factory=OPTConfig)
    max_txt_len: int = 32

    @staticmethod
    def tiny(**kw) -> "Blip2OPTConfig":
        d = dict(vit=EvaViTConfig.tiny(), qformer=QFormerConfig.tiny(),
                 opt=OPTConfig.tiny())
        d.update(kw)
        return Blip2OPTConfig(**d)


class Blip2OPT(nn.Module):
    """Built on the card unless ``device`` says otherwise (raises without a
    GPU when no device is given).  Parameters start uninitialized: load
    them with ``models/bridge.py``."""

    def __init__(self, cfg: Blip2OPTConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.visual_encoder = EvaViT(cfg.vit, device)
        self.ln_vision = LayerNorm(cfg.vit.embed_dim, 1e-6, device)
        # queries only: no text embeddings, no text FFN
        self.qformer = QFormer(cfg.qformer, device, text=False)
        self.opt_proj = SparseLinear(cfg.qformer.hidden_size,
                                     cfg.opt.hidden_size,
                                     param_dtype=torch.float32, device=device)
        self.opt_model = OPTForCausalLM(cfg.opt, device)

    @property
    def device(self) -> torch.device:
        return self.opt_proj.bias.device

    def encode_image(self, image, vit_mode="masked", qformer_mode="masked"):
        """Image → OPT-space prefix (b, 32, d), ``opt_proj`` dense in
        fp32."""
        feats = self.visual_encoder(image, mode=vit_mode)
        return self.encode_image_from_features(feats, qformer_mode)

    def encode_image_from_features(self, feats, qformer_mode="masked"):
        """Post-ViT half of encode_image."""
        cfg = self.cfg
        feats = self.ln_vision(feats.float())
        q = self.qformer(feats, mode=qformer_mode)
        q = q[:, :cfg.qformer.num_query_tokens]
        proj = self.opt_proj(q.float(), mode="dense")
        return proj.to(getattr(torch, cfg.opt.dtype))

    def forward(self, image, text_input_ids, text_attention_mask, labels,
                vit_mode: str = "masked", llm_mode: str = "masked",
                qformer_mode: str = "masked", **_ignored):
        prefix = self.encode_image(image, vit_mode, qformer_mode)
        embeds, attn = prefix_inputs(self.opt_model, prefix, text_input_ids,
                                     text_attention_mask)
        b, nq = prefix.shape[:2]
        full_labels = torch.cat([torch.full((b, nq), -100, dtype=labels.dtype,
                                            device=labels.device), labels],
                                dim=1)
        logits = self.opt_model(inputs_embeds=embeds, attention_mask=attn,
                                mode=llm_mode)
        loss = cross_entropy_loss(logits[:, :-1], full_labels[:, 1:])
        return {"loss": loss, "logits": logits}


@torch.no_grad()
def generate_opt(model: Blip2OPT, image, prompt_input_ids,
                 prompt_attention_mask,
                 gen_cfg: Optional[GenerationConfig] = None,
                 vit_mode="masked", llm_mode="masked", qformer_mode="masked",
                 generator: Optional[torch.Generator] = None,
                 speculative_gamma: int = 0, draft_llm_mode: str = "masked",
                 stats: Optional[dict] = None):
    """BLIP-2 OPT generate: the image prefix and the left-padded prompt
    minus its last token prime the OPT KV cache, repeated per beam; the
    last prompt token seeds beam search (num_beams > 1) or greedy /
    nucleus decoding.  Returns (b, max_length) ids whose first column is
    that last prompt token.

    ``speculative_gamma > 0`` (in place of beams, as in the JAX package):
    the ``draft_llm_mode`` cache proposes γ tokens, the ``llm_mode`` one
    verifies, the output is greedy under ``llm_mode``; ``stats``, a dict,
    receives the decode's ``rounds`` and ``committed``."""
    gen_cfg = gen_cfg or GenerationConfig(eos_token_id=2, pad_token_id=1)
    prefix = model.encode_image(image, vit_mode, qformer_mode)
    return decode_after_prefix(
        model.opt_model, prefix, prompt_input_ids, prompt_attention_mask,
        gen_cfg, llm_mode, generator, speculative_gamma, draft_llm_mode,
        stats)
