"""Registered pruner classes (port of the joint V+L orchestration of
``vlm_compression_tpu/compression/pruners/towers.py``, FlanT5 branch).

Orchestration as in the JAX package: ViT → T5 encoder → T5 decoder (or,
for InstructBLIP-Vicuna, ViT → one sweep over ``llm_model``'s blocks); in
the LoRA path (``lora_model=True``: masks kept) upstream towers run
``dense`` while a downstream tower calibrates; in the non-LoRA path the
pruned weights are zeroed and the sweeps chain (each tower's replayed
activations feed the next tower's stem).  ViT Wanda uses the per-tensor
flat threshold, the language towers per-unit top-k.  With a
``sparsity_ratio_granularity`` the ratios come from the ``LayerSparsity``
allocator (``compression/allocator.py``), built in ``get_sparsity``.

Registered here: ``{t5,vit,blipt5}_{wanda,sparsegpt,dsnot,ria,softmask,
gptq}_pruner``; the global pruners are in ``global_pruner.py``.  GPTQ's
prune spec keep-ratio 1.0 quantizes only; any other ratio or n:m prunes
and quantizes in one OBS sweep (fake-quant kernels in the model's dtype).
"""

from __future__ import annotations

import logging

import torch

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.compression import adapters as A
from vlm_compression_tpu_torch.compression.calibrate import (
    calibrate_and_prune_tower,
    with_outputs,
)
from vlm_compression_tpu_torch.compression.pruners import methods as M
from vlm_compression_tpu_torch.compression.pruners.base import (
    LayerWisePrunerBase,
    convert_spec_to_list,
)
from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
    prefix_inputs,
)
from vlm_compression_tpu_torch.models.t5 import shift_right
from vlm_compression_tpu_torch.ops import sparsegpt as SG


class _MethodMixin:
    method: str = "wanda"
    # DSnoT and SparseGPT knobs (reference CLI flags)
    initial_method: str = "wanda"
    max_cycle_time: int = 50
    update_threshold: float = 0.1
    pow_of_var_regrowing: float = 1.0
    without_same_sign: bool = True
    without_dsnot: bool = False
    blocksize: int = 128
    percdamp: float = 0.01
    # RIA's activation exponent (ops/masks.ria_metric)
    ria_alpha: float = 0.5
    # with n:m set, the tile of the hybrid masks (salient tiles dense, the
    # rest n:m); 0: plain n:m
    hybrid_tile: int = 0
    # the soft-mask anneal (ops/softmask.py)
    softmask_steps: int = 48
    softmask_lr: float = 0.1
    # GPTQ (ops/gptq.py) and its AWQ scale search (ops/awq.py)
    gptq_bits: int = 4
    gptq_group: int = 128
    gptq_sym: bool = True
    gptq_actorder: bool = False
    gptq_awq: bool = False

    @property
    def with_hessian(self) -> bool:
        if self.method in ("sparsegpt", "softmask", "gptq"):
            return True
        return self.method == "dsnot" and self.initial_method == "sparsegpt"

    def make_mask_fn(self, lora_model: bool, tower: str = "llm"):
        if self.method in ("wanda", "ria"):
            return M.wanda_mask_fn(self.prune_n, self.prune_m,
                                   flat_threshold=(tower == "vit"),
                                   metric=self.method,
                                   ria_alpha=self.ria_alpha,
                                   hybrid_tile=self.hybrid_tile)
        if self.method == "sparsegpt":
            return M.sparsegpt_mask_fn(self.prune_n, self.prune_m,
                                       self.blocksize, self.percdamp)
        if self.method == "dsnot":
            return M.dsnot_mask_fn(
                self.prune_n, self.prune_m, self.initial_method,
                self.max_cycle_time, self.update_threshold,
                self.pow_of_var_regrowing, self.without_same_sign,
                self.without_dsnot)
        if self.method == "softmask":
            # each linear's (err_best, err_init), for the caller to read
            self.softmask_errors = getattr(self, "softmask_errors", [])
            return M.softmask_mask_fn(
                self.prune_n, self.prune_m, steps=self.softmask_steps,
                lr=self.softmask_lr, errors=self.softmask_errors)
        if self.method == "gptq":
            return M.gptq_fn(
                self.prune_n, self.prune_m, bits=self.gptq_bits,
                groupsize=self.gptq_group, sym=self.gptq_sym,
                act_order=self.gptq_actorder, blocksize=self.blocksize,
                percdamp=self.percdamp, awq=self.gptq_awq)
        raise NotImplementedError(
            f"pruning method {self.method!r} is not ported yet")

    def _prune_tower(self, adapter, batches, sparsity_for, lora_model,
                     tower="llm", return_outputs=False):
        before = dict(SG.damped)
        out = calibrate_and_prune_tower(
            adapter, batches,
            mask_fn=self.make_mask_fn(lora_model, tower),
            sparsity_for=sparsity_for,
            with_hessian=self.with_hessian,
            lora_model=lora_model,
            progress=logging.info,
            return_outputs=return_outputs)
        if self.method == "sparsegpt":
            logging.info("[%s] sparsegpt damped Hessians: %d after a failed "
                         "factorization, %d after an overflowing inverse",
                         adapter.name,
                         SG.damped["factorization"] - before["factorization"],
                         SG.damped["inverse"] - before["inverse"])
        return out


class T5PrunerBase(_MethodMixin, LayerWisePrunerBase):
    """Prunes a bare T5ForConditionalGeneration: encoder, then decoder."""

    @torch.no_grad()
    def prune(self, lora_model: bool = True):
        t5 = self.model
        cfg = t5.cfg
        spec = convert_spec_to_list(self.prune_spec or self.t5_prune_spec)
        sfor = self.get_sparsity(1.0 - spec[1],
                                 self.sparsity_ratio_granularity)
        batches = self.batches()
        upstream = "dense" if lora_model else "masked"

        def embeds_fn(b):
            return t5.embed_tokens(b["input_ids"]), b.get("attention_mask")

        self._prune_tower(
            A.make_t5_encoder_adapter(t5.encoder, embeds_fn, ("encoder",)),
            batches, sfor, lora_model)

        def dec_inputs_fn(b):
            embeds, mask = embeds_fn(b)
            enc_out = t5.encode(inputs_embeds=embeds, attention_mask=mask,
                                mode=upstream)
            labels = b["labels"]
            dec_ids = shift_right(labels, cfg.decoder_start_token_id,
                                  cfg.pad_token_id)
            return (t5.embed_tokens(dec_ids), (labels != -100).to(
                torch.int32), enc_out, mask)

        self._prune_tower(
            A.make_t5_decoder_adapter(t5.decoder, dec_inputs_fn,
                                      ("decoder",)),
            batches, sfor, lora_model)
        return self.model, getattr(sfor, "mapping", None)


class ViTPrunerBase(_MethodMixin, LayerWisePrunerBase):
    """Prunes a bare EvaViT."""

    @torch.no_grad()
    def prune(self, lora_model: bool = True):
        vit = self.model
        spec = convert_spec_to_list(self.prune_spec or self.vit_prune_spec)
        sfor = self.get_sparsity(1.0 - spec[1],
                                 self.sparsity_ratio_granularity)
        self._prune_tower(
            A.make_vit_adapter(vit, lambda b: (vit.embed(b["image"]), {}),
                               ()),
            self.batches(), sfor, lora_model, tower="vit")
        return self.model, getattr(sfor, "mapping", None)


class BlipT5PrunerBase(_MethodMixin, LayerWisePrunerBase):
    def _allocation_prefixes(self):
        # only kernels under the t5/vit prefixes take part in the sparsity
        # allocation (the Q-Former is excluded), as in the reference
        return (self.vit_model_prefix, self.t5_model_prefix)

    @torch.no_grad()
    def prune(self, lora_model: bool = True):
        module = self.model   # Blip2T5Instruct or Blip2VicunaInstruct
        is_t5 = hasattr(module.cfg, "t5")
        vit_spec = convert_spec_to_list(self.vit_prune_spec)
        t5_spec = convert_spec_to_list(self.t5_prune_spec)
        vit_keep = vit_spec[1] if vit_spec else 1.0
        t5_keep = t5_spec[1] if t5_spec else 1.0

        sfor_global = None
        if self.sparsity_ratio_granularity not in (None, "none"):
            sfor_global = self.get_sparsity(1.0 - t5_keep,
                                            self.sparsity_ratio_granularity)
        batches = self.batches()
        # upstream dense iff that tower is being pruned in the LoRA path
        vit_mode_for_llm = ("dense" if (lora_model and vit_keep < 1.0)
                            else "masked")
        llm_upstream = "dense" if (lora_model and t5_keep < 1.0) else "masked"
        prune_vit = bool(vit_spec and vit_keep < 1.0)
        prune_llm = bool(t5_spec and t5_keep < 1.0)
        chain = (not lora_model) and prune_vit and prune_llm
        vit_outs = None

        if prune_vit:
            vit = module.visual_encoder
            ad = A.make_vit_adapter(
                vit, lambda b: (vit.embed(b["image"]), {}),
                (self.vit_model_prefix,))
            vit_outs = self._prune_tower(
                ad, batches, sfor_global or self.get_sparsity(1.0 - vit_keep),
                lora_model, tower="vit", return_outputs=chain)

        if prune_llm and not is_t5:
            # decoder-only LLM (Vicuna): one sweep over the llm_model blocks
            sfor = sfor_global or self.get_sparsity(1.0 - t5_keep)
            if chain:
                llm_batches = with_outputs(batches, vit_outs, "vit_x")
                vit_outs = None

                def llm_inputs_fn(b):
                    return _llm_inputs_from_prefix(
                        module, b, module.encode_image_from_features(
                            b["vit_x"], b.get("qformer_input_ids"),
                            b.get("qformer_attention_mask")))
            else:
                llm_batches = batches

                def llm_inputs_fn(b):
                    return _blip_llm_inputs(module, b, vit_mode_for_llm)

            self._prune_tower(
                A.make_llama_adapter(module.llm_model, llm_inputs_fn,
                                     ("llm_model",)),
                llm_batches, sfor, lora_model, tower="llm")
        elif prune_llm:
            sfor = sfor_global or self.get_sparsity(1.0 - t5_keep)
            t5 = module.t5_model
            if chain:
                # the engine fused the calibration batches when it could:
                # align the batch dicts with the replayed activations
                enc_batches = with_outputs(batches, vit_outs, "vit_x")
                vit_outs = None

                def enc_embeds_fn(b):
                    return _encoder_inputs_from_prefix(
                        module, b, module.encode_image_from_features(
                            b["vit_x"], b.get("qformer_input_ids"),
                            b.get("qformer_attention_mask")))
            else:
                enc_batches = batches

                def enc_embeds_fn(b):
                    return _blip_encoder_inputs(module, b, vit_mode_for_llm)

            enc_ad = A.make_t5_encoder_adapter(
                t5.encoder, enc_embeds_fn, (self.t5_model_prefix, "encoder"))
            enc_outs = self._prune_tower(enc_ad, enc_batches, sfor,
                                         lora_model, tower="llm",
                                         return_outputs=chain)
            if chain:
                dec_batches = with_outputs(enc_batches, enc_outs, "enc_x")
                enc_batches = enc_outs = None

                def dec_inputs_fn(b):
                    return _decoder_inputs_from_enc(module, b)
            else:
                dec_batches = batches

                def dec_inputs_fn(b):
                    return _blip_decoder_inputs(module, b, vit_mode_for_llm,
                                                llm_upstream)

            dec_ad = A.make_t5_decoder_adapter(
                t5.decoder, dec_inputs_fn, (self.t5_model_prefix, "decoder"))
            self._prune_tower(dec_ad, dec_batches, sfor, lora_model,
                              tower="llm")
        return self.model, getattr(sfor_global, "mapping", None)


def _llm_inputs_from_prefix(m, batch, prefix):
    """[query prefix ⊕ packed prompt+answer embeds] and its mask, given a
    prefix (the chained sweep feeds the pruned ViT's replayed features)."""
    return prefix_inputs(m.llm_model, prefix, batch["text_input_ids"],
                         batch["text_attention_mask"])


def _blip_llm_inputs(m, batch, vit_mode):
    prefix = m.encode_image(batch["image"], vit_mode,
                            batch.get("qformer_input_ids"),
                            batch.get("qformer_attention_mask"))
    return _llm_inputs_from_prefix(m, batch, prefix)


def _encoder_inputs_from_prefix(m, batch, prefix):
    """[query prefix ⊕ T5 token embeds] and its mask, given a prefix."""
    return m._encoder_inputs(prefix, batch["input_ids"],
                             batch["attention_mask"])


def _blip_encoder_inputs(m, batch, vit_mode):
    prefix = m.encode_image(batch["image"], vit_mode,
                            batch.get("qformer_input_ids"),
                            batch.get("qformer_attention_mask"))
    return _encoder_inputs_from_prefix(m, batch, prefix)


def _decoder_tail(m, batch, enc_out, enc_mask):
    t5cfg = m.cfg.t5
    dec_ids = shift_right(batch["labels"], t5cfg.decoder_start_token_id,
                          t5cfg.pad_token_id)
    dec_mask = (batch["labels"] != -100).to(torch.int32)
    return m.t5_model.embed_tokens(dec_ids), dec_mask, enc_out, enc_mask


def _blip_decoder_inputs(m, batch, vit_mode, llm_mode):
    embeds, mask = _blip_encoder_inputs(m, batch, vit_mode)
    enc_out = m.t5_model.encoder(embeds, mask, mode=llm_mode)
    return _decoder_tail(m, batch, enc_out, mask)


def _decoder_inputs_from_enc(m, batch):
    """Decoder stem from the encoder sweep's replayed last-block output
    (``enc_x``): only the encoder's final RMSNorm remains to apply."""
    enc_out = m.t5_model.encoder.final_norm(batch["enc_x"])
    b, nq = batch["enc_x"].shape[0], m.cfg.qformer.num_query_tokens
    am = batch["attention_mask"]
    enc_mask = torch.cat([torch.ones((b, nq), dtype=am.dtype,
                                     device=am.device), am], dim=1)
    return _decoder_tail(m, batch, enc_out, enc_mask)


def _make(base, method_name, reg_name):
    cls = type(f"{reg_name}_cls", (base,),
               {"method": method_name, "pruner_name": reg_name})
    registry.register_pruner(reg_name)(cls)
    return cls


T5WandaPruner = _make(T5PrunerBase, "wanda", "t5_wanda_pruner")
ViTWandaPruner = _make(ViTPrunerBase, "wanda", "vit_wanda_pruner")
BlipT5WandaPruner = _make(BlipT5PrunerBase, "wanda", "blipt5_wanda_pruner")

T5SparseGPTPruner = _make(T5PrunerBase, "sparsegpt", "t5_sparsegpt_pruner")
ViTSparseGPTPruner = _make(ViTPrunerBase, "sparsegpt", "vit_sparsegpt_pruner")
BlipT5SparseGPTPruner = _make(BlipT5PrunerBase, "sparsegpt",
                              "blipt5_sparsegpt_pruner")

T5DSnoTPruner = _make(T5PrunerBase, "dsnot", "t5_dsnot_pruner")
ViTDSnoTPruner = _make(ViTPrunerBase, "dsnot", "vit_dsnot_pruner")
BlipT5DSnoTPruner = _make(BlipT5PrunerBase, "dsnot", "blipt5_dsnot_pruner")

# RIA (relative importance × activations): the Wanda sweep with another
# metric (ops/masks.ria_metric)
T5RIAPruner = _make(T5PrunerBase, "ria", "t5_ria_pruner")
ViTRIAPruner = _make(ViTPrunerBase, "ria", "vit_ria_pruner")
BlipT5RIAPruner = _make(BlipT5PrunerBase, "ria", "blipt5_ria_pruner")

# annealed Hessian-guided soft-mask n:m (ops/softmask.py)
T5SoftMaskPruner = _make(T5PrunerBase, "softmask", "t5_softmask_pruner")
ViTSoftMaskPruner = _make(ViTPrunerBase, "softmask", "vit_softmask_pruner")
BlipT5SoftMaskPruner = _make(BlipT5PrunerBase, "softmask",
                             "blipt5_softmask_pruner")

# GPTQ (ops/gptq.py): keep-ratio 1.0 in the prune spec quantizes only; any
# other ratio or n:m prunes and quantizes in one OBS sweep
T5GPTQPruner = _make(T5PrunerBase, "gptq", "t5_gptq_pruner")
ViTGPTQPruner = _make(ViTPrunerBase, "gptq", "vit_gptq_pruner")
BlipT5GPTQPruner = _make(BlipT5PrunerBase, "gptq", "blipt5_gptq_pruner")
