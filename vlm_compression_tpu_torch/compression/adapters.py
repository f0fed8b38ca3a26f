"""Tower adapters binding the models to the calibration engine (port of
``vlm_compression_tpu/compression/adapters.py``: ViT, T5 encoder, T5
decoder, the decoder-only LLaMA).

An adapter owns the block application and the side inputs; the stem —
everything upstream of block 0 — is a closure from the pruner, which
knows the composition and the calibration dataflow (upstream towers run
``dense`` while a downstream tower calibrates in the LoRA path).
Calibration statistics include padded positions, as the reference's
hooks do.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from vlm_compression_tpu_torch.compression.calibrate import TowerAdapter
from vlm_compression_tpu_torch.models.eva_vit import EvaViT
from vlm_compression_tpu_torch.models.llama import LlamaForCausalLM
from vlm_compression_tpu_torch.models.t5 import (
    T5Decoder,
    T5Encoder,
    causal_mask,
    extend_mask,
)


def make_vit_adapter(vit: EvaViT, stem_fn: Callable,
                     subtree: Tuple[str, ...] = ("visual_encoder",)
                     ) -> TowerAdapter:
    """stem_fn(batch) -> (x0, {}) — the ViT embed output."""
    return TowerAdapter(
        name="vit", blocks=vit, block_names=list(vit.block_names),
        block_fn=lambda blk, x, side, mode: blk(x, mode),
        stem_fn=stem_fn, subtree=subtree)


def make_t5_encoder_adapter(encoder: T5Encoder, embeds_fn: Callable,
                            subtree: Tuple[str, ...] = ("encoder",)
                            ) -> TowerAdapter:
    """embeds_fn(batch) -> (inputs_embeds, attention_mask|None).  The
    relative-position bias comes from the stack's own ``rel_bias`` and the
    padding mask rides beside it, as in the encoder forward."""

    def stem_fn(batch):
        embeds, attn_mask = embeds_fn(batch)
        n = embeds.shape[1]
        return embeds, {"self_bias": encoder.rel_bias(n, n),
                        "self_mask": extend_mask(attn_mask)}

    def block_fn(blk, x, side, mode):
        return blk(x, None, side["self_bias"], side["self_mask"], None,
                   mode=mode)

    return TowerAdapter(
        name="t5_encoder", blocks=encoder,
        block_names=list(encoder.block_names),
        block_fn=block_fn, stem_fn=stem_fn, subtree=subtree)


def make_t5_decoder_adapter(decoder: T5Decoder, decoder_inputs_fn: Callable,
                            subtree: Tuple[str, ...] = ("decoder",)
                            ) -> TowerAdapter:
    """decoder_inputs_fn(batch) ->
    (dec_embeds, dec_mask|None, enc_out, enc_mask|None); enc_out already
    follows the calibration dataflow policy (the pruner decides)."""

    def stem_fn(batch):
        dec_embeds, dec_mask, enc_out, enc_mask = decoder_inputs_fn(batch)
        n = dec_embeds.shape[1]
        bias = decoder.rel_bias(n, n) + causal_mask(n, device=dec_embeds.device)
        return dec_embeds, {"enc_out": enc_out, "self_bias": bias,
                            "self_mask": extend_mask(dec_mask),
                            "cross_mask": extend_mask(enc_mask)}

    def block_fn(blk, x, side, mode):
        return blk(x, side["enc_out"], side["self_bias"], side["self_mask"],
                   side["cross_mask"], mode=mode)

    return TowerAdapter(
        name="t5_decoder", blocks=decoder,
        block_names=list(decoder.block_names),
        block_fn=block_fn, stem_fn=stem_fn, subtree=subtree)


def make_llama_adapter(llm: LlamaForCausalLM, inputs_fn: Callable,
                       subtree: Tuple[str, ...] = ("llm_model",)
                       ) -> TowerAdapter:
    """Decoder-only (LLaMA / Vicuna) layer sweep.  inputs_fn(batch) ->
    (inputs_embeds, attention_mask|None).  The stem builds the side inputs
    as the JAX stem does: the causal −1e9 mask plus the padding bias, one
    (b, 1, n, n) bias, and the rotary positions ``cumsum(mask) − 1``."""

    def stem_fn(batch):
        embeds, attn_mask = inputs_fn(batch)
        b, n, _ = embeds.shape
        dev = embeds.device
        mask = causal_mask(n, device=dev)
        if attn_mask is not None:
            mask = mask + extend_mask(attn_mask)
            positions = torch.clamp(
                torch.cumsum(attn_mask.to(torch.int32), dim=-1) - 1, min=0)
        else:
            positions = torch.arange(n, device=dev)[None].expand(b, n)
        return embeds, {"mask": mask, "positions": positions}

    def block_fn(blk, x, side, mode):
        return blk(x, side["mask"], side["positions"], mode=mode)

    return TowerAdapter(
        name="llama", blocks=llm, block_names=list(llm.block_names),
        block_fn=block_fn, stem_fn=stem_fn, subtree=subtree)
