"""InstructBLIP (FlanT5) — the flagship composition (port of
``vlm_compression_tpu/models/blip2_t5_instruct.py``).

ViT → ln_vision → Q-Former(queries + instruction) → t5_proj → prepended to
the T5 token embeddings → T5 encoder/decoder.  Each tower takes a mode
(``vit_mode``, ``qformer_mode``, ``llm_mode``): ``dense`` is the teacher
path, ``masked`` the pruned model.  Tokenization happens in the data
layer; the model consumes ids and masks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.eva_vit import EvaViT, EvaViTConfig
from vlm_compression_tpu_torch.models.generation import (
    GenerationConfig,
    beam_search,
    greedy_generate,
    make_t5_step,
    speculative_generate,
    speculative_max_len,
)
from vlm_compression_tpu_torch.models.layers import LayerNorm, SparseLinear
from vlm_compression_tpu_torch.models.qformer import QFormer, QFormerConfig
from vlm_compression_tpu_torch.models.t5 import (
    T5Config,
    T5ForConditionalGeneration,
    cross_entropy_loss,
    shift_right,
)


@dataclasses.dataclass(frozen=True)
class Blip2T5InstructConfig:
    vit: EvaViTConfig = dataclasses.field(default_factory=EvaViTConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    t5: T5Config = dataclasses.field(default_factory=T5Config)
    max_txt_len: int = 128
    max_output_txt_len: int = 256

    @staticmethod
    def flan_t5_xl(**kw) -> "Blip2T5InstructConfig":
        return Blip2T5InstructConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "Blip2T5InstructConfig":
        d = dict(vit=EvaViTConfig.tiny(), qformer=QFormerConfig.tiny(),
                 t5=T5Config.tiny(d_model=16))
        d.update(kw)
        return Blip2T5InstructConfig(**d)


class Blip2T5Instruct(nn.Module):
    """Built on the card unless ``device`` says otherwise (raises without a
    GPU when no device is given).  Parameters start uninitialized: load
    them with ``models/bridge.py``."""

    def __init__(self, cfg: Blip2T5InstructConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.visual_encoder = EvaViT(cfg.vit, device)
        self.ln_vision = LayerNorm(cfg.vit.embed_dim, 1e-6, device)
        self.qformer = QFormer(cfg.qformer, device)
        self.t5_proj = SparseLinear(cfg.qformer.hidden_size, cfg.t5.d_model,
                                    param_dtype=torch.float32, device=device)
        self.t5_model = T5ForConditionalGeneration(cfg.t5, device)

    @property
    def device(self) -> torch.device:
        # the bias: an int4 projection has no float ``kernel``
        return self.t5_proj.bias.device

    def encode_image(self, image, vit_mode="masked", qformer_input_ids=None,
                     qformer_attention_mask=None, qformer_mode="masked"):
        """Image (+instruction) → T5-space prefix embeddings (b, 32, d).

        Video: a 5-dim ``(b, t, H, W, 3)`` stack folds its frames into the
        batch (each request's instruction repeated per frame), so the ViT
        and the Q-Former run once; the per-frame query outputs are
        concatenated along the sequence → ``(b, t·32, d)``."""
        if image.dim() == 5:
            b, t = image.shape[:2]
            image = image.reshape((b * t,) + tuple(image.shape[2:]))
            if qformer_input_ids is not None:
                qformer_input_ids = qformer_input_ids.repeat_interleave(
                    t, dim=0)
                if qformer_attention_mask is not None:
                    qformer_attention_mask = \
                        qformer_attention_mask.repeat_interleave(t, dim=0)
            proj = self.encode_image(image, vit_mode, qformer_input_ids,
                                     qformer_attention_mask, qformer_mode)
            return proj.reshape(b, t * proj.shape[1], proj.shape[2])
        feats = self.visual_encoder(image, mode=vit_mode)
        return self.encode_image_from_features(
            feats, qformer_input_ids, qformer_attention_mask, qformer_mode)

    def encode_image_from_features(self, feats, qformer_input_ids=None,
                                   qformer_attention_mask=None,
                                   qformer_mode="masked"):
        """Post-ViT half of encode_image (the calibration engine feeds a
        pruned tower's replayed activations here)."""
        cfg = self.cfg
        feats = self.ln_vision(feats.float())
        q_out = self.qformer(feats, qformer_input_ids, qformer_attention_mask,
                             mode=qformer_mode)
        q_out = q_out[:, :cfg.qformer.num_query_tokens]
        proj = self.t5_proj(q_out.float(), mode="dense")
        return proj.to(getattr(torch, cfg.t5.dtype))

    def _encoder_inputs(self, prefix, input_ids, attention_mask):
        b, nq = prefix.shape[:2]
        embeds = torch.cat([prefix, self.t5_model.embed_tokens(input_ids)],
                           dim=1)
        enc_mask = torch.cat([torch.ones((b, nq), dtype=attention_mask.dtype,
                                         device=attention_mask.device),
                              attention_mask], dim=1)
        return embeds, enc_mask

    def forward(self, image, input_ids, attention_mask, labels,
                qformer_input_ids=None, qformer_attention_mask=None,
                vit_mode: str = "masked", llm_mode: str = "masked",
                qformer_mode: str = "masked"):
        cfg = self.cfg
        prefix = self.encode_image(image, vit_mode, qformer_input_ids,
                                   qformer_attention_mask, qformer_mode)
        embeds, enc_mask = self._encoder_inputs(prefix, input_ids,
                                                attention_mask)
        dec_ids = shift_right(labels, cfg.t5.decoder_start_token_id,
                              cfg.t5.pad_token_id)
        dec_mask = (labels != -100).to(enc_mask.dtype)
        enc = self.t5_model.encode(inputs_embeds=embeds,
                                   attention_mask=enc_mask, mode=llm_mode)
        logits = self.t5_model.decode(dec_ids, enc, dec_mask, enc_mask,
                                      mode=llm_mode)
        return {"loss": cross_entropy_loss(logits, labels), "logits": logits}

    def encode_multimodal(self, image, input_ids, attention_mask,
                          qformer_input_ids=None, qformer_attention_mask=None,
                          vit_mode="masked", llm_mode="masked",
                          qformer_mode="masked"):
        """(enc_out, enc_mask): the T5 encoder over [image prefix ⊕ prompt]."""
        prefix = self.encode_image(image, vit_mode, qformer_input_ids,
                                   qformer_attention_mask, qformer_mode)
        embeds, enc_mask = self._encoder_inputs(prefix, input_ids,
                                                attention_mask)
        enc = self.t5_model.encode(inputs_embeds=embeds,
                                   attention_mask=enc_mask, mode=llm_mode)
        return enc, enc_mask


# fp32 logits a ``predict_class_t5`` chunk may hold: b · C · L rows × the
# vocabulary grow fast at XL (64 questions × 128 candidates × 4 tokens ×
# 32128 is 4.2 GB), so the candidates go through the decoder in chunks
_LOGIT_BYTES = 1 << 30


@torch.no_grad()
def predict_class_t5(model: Blip2T5Instruct, image, input_ids, attention_mask,
                     candidate_labels, qformer_input_ids=None,
                     qformer_attention_mask=None, vit_mode="masked",
                     llm_mode="masked", qformer_mode="masked"):
    """Candidate ranking: the decoder's summed negative log-likelihood of
    each candidate answer, (b, C) float32 (lower is better).
    ``candidate_labels``: (C, L) int, -100 padded.  The image and prompt
    are encoded once; the candidates run the decoder in chunks of whole
    candidates, so each row's sum is taken over its own L tokens alone."""
    cfg = model.cfg
    enc, enc_mask = model.encode_multimodal(
        image, input_ids, attention_mask, qformer_input_ids,
        qformer_attention_mask, vit_mode, llm_mode, qformer_mode)
    b = enc.shape[0]
    labels_all = candidate_labels.to(enc.device)
    C, L = labels_all.shape
    chunk = max(1, _LOGIT_BYTES // (b * L * cfg.t5.vocab_size * 4))
    nll = []
    for c0 in range(0, C, chunk):
        labels = labels_all[c0:c0 + chunk]
        c = labels.shape[0]
        labels = labels.repeat(b, 1)                     # (b·c, L), b-major
        dec_ids = shift_right(labels, cfg.t5.decoder_start_token_id,
                              cfg.t5.pad_token_id)
        logits = model.t5_model.decode(
            dec_ids, enc.repeat_interleave(c, dim=0), None,
            enc_mask.repeat_interleave(c, dim=0), mode=llm_mode)
        logp = torch.log_softmax(logits, dim=-1)
        valid = labels != -100
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        ll = torch.gather(logp, -1, safe[..., None].long())[..., 0]
        nll.append(-(ll * valid).sum(-1).reshape(b, c))
        del logits, logp
    return torch.cat(nll, dim=1)


@torch.no_grad()
def generate_t5(model: Blip2T5Instruct, image, input_ids, attention_mask,
                qformer_input_ids=None, qformer_attention_mask=None,
                gen_cfg: Optional[GenerationConfig] = None,
                vit_mode="masked", llm_mode="masked", qformer_mode="masked",
                generator: Optional[torch.Generator] = None,
                speculative_gamma: int = 0, draft_llm_mode: str = "masked",
                stats: Optional[dict] = None):
    """InstructBLIP-T5 generate: beam search (num_beams > 1) or greedy /
    nucleus over the image-conditioned encoder output.  Returns token ids
    (b, max_length) starting with the decoder start token.

    ``speculative_gamma > 0`` (no beams): the ``draft_llm_mode`` decoder
    proposes γ tokens, the ``llm_mode`` one verifies them in one chunked
    pass; the output is greedy under ``llm_mode`` (the serving pairing:
    llm_mode "dense", the teacher; draft "masked", the student).  Both
    decoders read the one encoding made under ``llm_mode``.  ``stats``, a
    dict, receives the decode's ``rounds`` and ``committed``."""
    cfg = model.cfg
    gen_cfg = gen_cfg or GenerationConfig(
        num_beams=5, max_length=30, min_length=1,
        decoder_start_token_id=cfg.t5.decoder_start_token_id,
        pad_token_id=cfg.t5.pad_token_id, eos_token_id=1)
    enc, enc_mask = model.encode_multimodal(
        image, input_ids, attention_mask, qformer_input_ids,
        qformer_attention_mask, vit_mode, llm_mode, qformer_mode)
    b = enc.shape[0]
    k = gen_cfg.num_beams
    if k > 1:
        step, cache = make_t5_step(
            model.t5_model, enc.repeat_interleave(k, dim=0),
            enc_mask.repeat_interleave(k, dim=0), llm_mode,
            gen_cfg.max_length)
        return beam_search(step, cache, b, gen_cfg, device=enc.device)[0]
    if speculative_gamma > 0:
        max_len = speculative_max_len(gen_cfg.max_length, speculative_gamma,
                                      cfg.t5.kv_cache_per_row)
        dstep, dcache = make_t5_step(model.t5_model, enc, enc_mask,
                                     draft_llm_mode, max_len)
        tstep, tcache = make_t5_step(model.t5_model, enc, enc_mask, llm_mode,
                                     max_len)
        seqs, _, st = speculative_generate(
            dstep, dcache, tstep, tcache, b, gen_cfg,
            gamma=speculative_gamma, generator=generator, device=enc.device)
        if stats is not None:
            stats.update(st)
        return seqs
    step, cache = make_t5_step(model.t5_model, enc, enc_mask, llm_mode,
                               gen_cfg.max_length)
    return greedy_generate(step, cache, b, gen_cfg, device=enc.device,
                           generator=generator)[0]
