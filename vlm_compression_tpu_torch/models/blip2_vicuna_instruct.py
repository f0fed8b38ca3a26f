"""InstructBLIP-Vicuna — the decoder-only composition (port of
``vlm_compression_tpu/models/blip2_vicuna_instruct.py``).

ViT → ln_vision → Q-Former(queries + instruction) → llm_proj → prepended to
the LLaMA token embeddings.  The model consumes ``text_input_ids`` (prompt
then answer, packed and right-padded by the collator), its
``text_attention_mask`` and ``labels`` (-100 on the prompt and the pads).
Generation primes the KV cache with [image prefix ⊕ left-padded prompt
minus its last token] and starts the decode from that last token (beam,
greedy, nucleus or speculative).  Candidate ranking on Vicuna is not ported
yet, and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.blip2_t5_instruct import Blip2T5Instruct
from vlm_compression_tpu_torch.models.eva_vit import EvaViT, EvaViTConfig
from vlm_compression_tpu_torch.models.generation import (
    GenerationConfig,
    beam_search,
    greedy_generate,
    speculative_generate,
    speculative_max_len,
    with_start,
)
from vlm_compression_tpu_torch.models.layers import LayerNorm, SparseLinear
from vlm_compression_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    make_causal_step,
)
from vlm_compression_tpu_torch.models.qformer import QFormer, QFormerConfig
from vlm_compression_tpu_torch.models.t5 import cross_entropy_loss


@dataclasses.dataclass(frozen=True)
class Blip2VicunaInstructConfig:
    vit: EvaViTConfig = dataclasses.field(default_factory=EvaViTConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    llm: LlamaConfig = dataclasses.field(default_factory=LlamaConfig)
    max_txt_len: int = 128
    max_output_txt_len: int = 256

    @staticmethod
    def vicuna_7b(**kw) -> "Blip2VicunaInstructConfig":
        return Blip2VicunaInstructConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "Blip2VicunaInstructConfig":
        d = dict(vit=EvaViTConfig.tiny(), qformer=QFormerConfig.tiny(),
                 llm=LlamaConfig.tiny())
        d.update(kw)
        return Blip2VicunaInstructConfig(**d)


class Blip2VicunaInstruct(nn.Module):
    """Built on the card unless ``device`` says otherwise (raises without a
    GPU when no device is given).  Parameters start uninitialized: load
    them with ``models/bridge.py``."""

    def __init__(self, cfg: Blip2VicunaInstructConfig,
                 device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.visual_encoder = EvaViT(cfg.vit, device)
        self.ln_vision = LayerNorm(cfg.vit.embed_dim, 1e-6, device)
        self.qformer = QFormer(cfg.qformer, device)
        self.llm_proj = SparseLinear(cfg.qformer.hidden_size,
                                     cfg.llm.hidden_size,
                                     param_dtype=torch.float32, device=device)
        self.llm_model = LlamaForCausalLM(cfg.llm, device)

    @property
    def device(self) -> torch.device:
        # the bias: an int4 projection has no float ``kernel``
        return self.llm_proj.bias.device

    # the ViT and Q-Former half, 5-dim (video) stacks included, is the T5
    # composition's; only the projection into the LM differs
    encode_image = Blip2T5Instruct.encode_image

    def encode_image_from_features(self, feats, qformer_input_ids=None,
                                   qformer_attention_mask=None,
                                   qformer_mode="masked"):
        """Post-ViT half of encode_image: → LLaMA-space prefix (b, 32, d),
        ``llm_proj`` dense in fp32."""
        cfg = self.cfg
        feats = self.ln_vision(feats.float())
        q_out = self.qformer(feats, qformer_input_ids, qformer_attention_mask,
                             mode=qformer_mode)
        q_out = q_out[:, :cfg.qformer.num_query_tokens]
        proj = self.llm_proj(q_out.float(), mode="dense")
        return proj.to(getattr(torch, cfg.llm.dtype))

    def forward(self, image, text_input_ids, text_attention_mask, labels,
                qformer_input_ids=None, qformer_attention_mask=None,
                vit_mode: str = "masked", llm_mode: str = "masked",
                qformer_mode: str = "masked"):
        """labels: as long as text_input_ids, -100 on the prompt and pads;
        the query positions never carry a target."""
        prefix = self.encode_image(image, vit_mode, qformer_input_ids,
                                   qformer_attention_mask, qformer_mode)
        embeds, attn = prefix_inputs(self, prefix, text_input_ids,
                                     text_attention_mask)
        b, nq = prefix.shape[:2]
        full_labels = torch.cat([torch.full((b, nq), -100, dtype=labels.dtype,
                                            device=labels.device), labels],
                                dim=1)
        logits = self.llm_model(inputs_embeds=embeds, attention_mask=attn,
                                mode=llm_mode)
        loss = cross_entropy_loss(logits[:, :-1], full_labels[:, 1:])
        return {"loss": loss, "logits": logits}


def prefix_inputs(model: Blip2VicunaInstruct, prefix, ids, mask):
    """[image prefix ⊕ token embeds of ``ids``] and its attention mask."""
    b, nq = prefix.shape[:2]
    embeds = torch.cat([prefix, model.llm_model.embed_tokens(ids)], dim=1)
    attn = torch.cat([torch.ones((b, nq), dtype=mask.dtype,
                                 device=mask.device), mask], dim=1)
    return embeds, attn


@torch.no_grad()
def generate_vicuna(model: Blip2VicunaInstruct, image, prompt_input_ids,
                    prompt_attention_mask, qformer_input_ids=None,
                    qformer_attention_mask=None,
                    gen_cfg: Optional[GenerationConfig] = None,
                    vit_mode="masked", llm_mode="masked",
                    qformer_mode="masked",
                    generator: Optional[torch.Generator] = None,
                    speculative_gamma: int = 0,
                    draft_llm_mode: str = "masked",
                    stats: Optional[dict] = None):
    """InstructBLIP-Vicuna generate: the image prefix and the left-padded
    prompt (BOS first) minus its last token prime the KV cache, repeated
    per beam; the last prompt token seeds beam search (num_beams > 1) or
    greedy / nucleus decoding.  Returns (b, max_length) ids whose first
    column is that last prompt token.

    ``speculative_gamma > 0`` (in place of beams, as in the JAX package):
    each of the ``draft_llm_mode`` and ``llm_mode`` caches is primed under
    its own mode; the draft proposes γ tokens, ``llm_mode`` verifies, and
    the output is greedy under ``llm_mode``.  ``stats``, a dict, receives
    the decode's ``rounds`` and ``committed``."""
    cfg = model.cfg
    gen_cfg = gen_cfg or GenerationConfig(
        eos_token_id=cfg.llm.eos_token_id, pad_token_id=cfg.llm.pad_token_id)
    prefix = model.encode_image(image, vit_mode, qformer_input_ids,
                                qformer_attention_mask, qformer_mode)
    prefix_embeds, prefix_mask = prefix_inputs(
        model, prefix, prompt_input_ids[:, :-1],
        prompt_attention_mask[:, :-1].to(torch.int32))
    b = prefix.shape[0]
    start = prompt_input_ids[:, -1].to(torch.int32)
    # the loops seed every row with decoder_start_token_id; -1 stands for
    # the row's own last prompt token
    gcfg = dataclasses.replace(gen_cfg, decoder_start_token_id=-1)
    if speculative_gamma > 0:
        max_len = speculative_max_len(gen_cfg.max_length, speculative_gamma,
                                      cfg.llm.kv_cache_per_row)
        dstep, dcache = make_causal_step(model.llm_model, prefix_embeds,
                                         prefix_mask, mode=draft_llm_mode,
                                         max_decode_len=max_len)
        tstep, tcache = make_causal_step(model.llm_model, prefix_embeds,
                                         prefix_mask, mode=llm_mode,
                                         max_decode_len=max_len)
        seqs, _, st = speculative_generate(
            with_start(dstep, start), dcache, with_start(tstep, start),
            tcache, b, gcfg, gamma=speculative_gamma, generator=generator,
            cache_offset=prefix_embeds.shape[1], device=prefix.device)
        if stats is not None:
            stats.update(st)
        seqs[:, 0] = start
        return seqs
    k = gen_cfg.num_beams
    if k > 1:
        prefix_embeds = prefix_embeds.repeat_interleave(k, dim=0)
        prefix_mask = prefix_mask.repeat_interleave(k, dim=0)
    step, cache = make_causal_step(model.llm_model, prefix_embeds,
                                   prefix_mask, mode=llm_mode,
                                   max_decode_len=gen_cfg.max_length)
    step_with_start = with_start(
        step, start.repeat_interleave(k) if k > 1 else start)
    if k > 1:
        seqs = beam_search(step_with_start, cache, b, gcfg,
                           device=prefix.device)[0]
    else:
        seqs = greedy_generate(step_with_start, cache, b, gcfg,
                               device=prefix.device, generator=generator)[0]
    seqs[:, 0] = start
    return seqs


def predict_class_vicuna(*args, **kw):
    """Candidate ranking on Vicuna: no Vicuna eval yaml ranks."""
    raise NotImplementedError(
        "candidate ranking on InstructBLIP-Vicuna (predict_class_vicuna) is "
        "not ported yet (ROADMAP queue 1, item 8)")
