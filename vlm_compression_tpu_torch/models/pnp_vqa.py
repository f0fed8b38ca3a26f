"""PNP-VQA and Img2Prompt-VQA, and the UnifiedQAv2 Fusion-in-Decoder
reader (port of ``vlm_compression_tpu/models/pnp_vqa.py``).

Three frozen models composed (``itm``, ``cap``, ``reader``):

  1. BLIP-1 image-question matching: the patch relevance is the gradient
     of Σ(logit₁ − logit₀) of the ITM head with respect to the image
     tokens, times the tokens, ReLU, summed over channels, CLS dropped
     (``forward_itm``).  It is taken with ``torch.autograd.grad`` under
     ``torch.enable_grad()`` with the ITM model's parameters frozen for the
     call, so it works inside a task's ``no_grad`` and asks each masked
     product for dx alone and each attention backward for the gradients of
     its key and value inputs (the image tokens' path) and no bias
     gradient;
  2. the BLIP-1 captioner over [CLS ⊕ the top-k relevant patches]
     (``forward_cap``; ties in the relevance go to the lower index, as
     ``jax.lax.top_k`` breaks them);
  3. the reader: a T5 that encodes each (question ⊕ caption) context on
     its own, concatenates the encodings along length and decodes once
     over them all (``UnifiedQAv2FiD``).

As in the JAX package, the ITM model builds only its ITM head and the
captioner no vision tower (it reads the ITM model's image tokens), so the
parameters are the JAX tree's leaf for leaf.  Built on the card unless
``device`` says otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.blip1 import (
    Blip1Config,
    BlipCaption,
    BlipITM,
)
from vlm_compression_tpu_torch.models.t5 import (
    T5Config,
    T5ForConditionalGeneration,
)


@dataclasses.dataclass(frozen=True)
class PNPVQAConfig:
    blip: Blip1Config = dataclasses.field(default_factory=Blip1Config.base)
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    num_patches: int = 20              # top-k patches kept for captioning
    num_captions: int = 50
    block_num: int = 7                 # cross-attention block for gradcam

    @staticmethod
    def base(**kw) -> "PNPVQAConfig":
        return PNPVQAConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "PNPVQAConfig":
        d = dict(blip=Blip1Config.tiny(), t5=T5Config.tiny(),
                 num_patches=2, num_captions=2, block_num=1)
        d.update(kw)
        return PNPVQAConfig(**d)


@contextlib.contextmanager
def frozen(module: nn.Module):
    """``module``'s parameters need no gradient inside the block (their
    flags restored after)."""
    params = [p for p in module.parameters() if p.requires_grad]
    for p in params:
        p.requires_grad_(False)
    try:
        yield
    finally:
        for p in params:
            p.requires_grad_(True)


def top_k_lower_index(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of each row's k largest entries, largest first, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    return torch.argsort(-x, dim=-1, stable=True)[..., :k]


class UnifiedQAv2FiD(nn.Module):
    """T5 with Fusion-in-Decoder: (b, n_ctx, L) context ids encoded one
    context at a time, the encodings concatenated along length, one
    decoder pass over all of them."""

    def __init__(self, cfg: T5Config, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        self.t5 = T5ForConditionalGeneration(cfg, resolve_device(device))

    @property
    def device(self) -> torch.device:
        return self.t5.shared.embedding.device

    def encode_contexts(self, ctx_ids, ctx_mask, mode="masked"):
        b, n_ctx, length = ctx_ids.shape
        enc = self.t5.encode(input_ids=ctx_ids.reshape(b * n_ctx, length),
                             attention_mask=ctx_mask.reshape(b * n_ctx,
                                                             length),
                             mode=mode)
        return (enc.reshape(b, n_ctx * length, enc.shape[-1]),
                ctx_mask.reshape(b, n_ctx * length))

    def forward(self, ctx_ids, ctx_mask, labels=None, decoder_input_ids=None,
                mode: str = "masked"):
        enc, enc_mask = self.encode_contexts(ctx_ids, ctx_mask, mode=mode)
        if decoder_input_ids is None:
            # shift right with a pad (0) start, the T5 convention
            decoder_input_ids = nn.functional.pad(labels, (1, 0))[:, :-1] \
                .clamp(min=0)
        logits = self.t5.decode(decoder_input_ids, enc, enc_mask=enc_mask,
                                mode=mode)
        out = {"logits": logits}
        if labels is not None:
            lp = torch.log_softmax(logits.float(), dim=-1)
            msk = (labels >= 0).float()
            tgt = labels.clamp(0, logits.shape[-1] - 1).long()
            nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
            out["loss"] = (nll * msk).sum() / msk.sum().clamp(min=1.0)
        return out


class _MatchingModel(BlipITM):
    """The ITM stage: BLIP-1 with its ITM head only."""

    HEADS = ("itm",)


class _CaptionModel(BlipCaption):
    """The caption stage: the decoder over the ITM stage's image tokens,
    no vision tower of its own."""

    VISION = False


class PNPVQA(nn.Module):
    """The pipeline's stages as methods (``forward_itm``, ``forward_cap``,
    the reader); ``forward`` runs the relevance, a caption LM pass and the
    reader's loss in one call."""

    def __init__(self, cfg: PNPVQAConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.itm = _MatchingModel(cfg.blip, device)
        self.cap = _CaptionModel(cfg.blip, device)
        self.reader = UnifiedQAv2FiD(cfg.t5, device)

    @property
    def device(self) -> torch.device:
        return self.itm.device

    def forward_itm(self, image, q_ids, q_mask, mode="masked"):
        """(relevance (b, patches), image tokens (b, 1 + patches, d)): the
        gradient of the ITM match logit's margin with respect to the image
        tokens, times the tokens, ReLU, summed over channels, CLS
        dropped."""
        itm = self.itm
        img = itm.encode_image(image, mode=mode)
        tokens = img.detach()
        with torch.enable_grad(), frozen(itm):
            x = tokens.clone().requires_grad_(True)
            logits = itm.itm_logits(q_ids, q_mask, x, mode=mode)
            (grad,) = torch.autograd.grad((logits[:, 1] - logits[:, 0]).sum(),
                                          x)
        rel = torch.relu(grad * tokens).sum(-1)[:, 1:]
        return rel, img

    def forward_cap(self, image_embeds, relevance, cap_ids, cap_mask=None,
                    mode="masked"):
        """Caption LM logits over [CLS ⊕ the top-k relevant patches]."""
        k = min(self.cfg.num_patches, relevance.shape[1])
        top = top_k_lower_index(relevance, k) + 1          # +1: skip CLS
        patches = torch.gather(image_embeds, 1, top[..., None].expand(
            -1, -1, image_embeds.shape[-1]))
        ctx = torch.cat([image_embeds[:, :1], patches], dim=1)
        return self.cap.decode_step(ctx, cap_ids, cap_mask, mode=mode)

    def forward(self, image, input_ids, attention_mask=None, cap_ids=None,
                ctx_ids=None, ctx_mask=None, labels=None,
                mode: str = "masked"):
        rel, img = self.forward_itm(image, input_ids, attention_mask,
                                    mode=mode)
        out = {"relevance": rel}
        if cap_ids is not None:
            out["caption_logits"] = self.forward_cap(img, rel, cap_ids,
                                                     mode=mode)
        if ctx_ids is not None:
            out.update(self.reader(ctx_ids, ctx_mask, labels=labels,
                                   mode=mode))
        return out


class Img2PromptVQA(PNPVQA):
    """Img2Prompt: the ITM and caption stages of PNP-VQA; the reader is
    replaced by a prompt for a frozen LLM, built on the host."""

    @staticmethod
    def build_prompt(captions: Sequence[str], question: str,
                     exemplars: Optional[Sequence[tuple]] = None) -> str:
        lines = ["Contexts: " + " ".join(captions)]
        for q, a in (exemplars or ()):
            lines.append(f"Question: {q} Answer: {a}")
        lines.append(f"Question: {question} Answer:")
        return "\n".join(lines)


PNP_MODELS = {"pnp_vqa": PNPVQA, "img2prompt_vqa": Img2PromptVQA,
              "pnp_unifiedqav2_fid": UnifiedQAv2FiD}
