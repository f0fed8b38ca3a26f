"""RESSA retraining: SparseLoRA + cross-modality knowledge distillation
(port of ``vlm_compression_tpu/tasks/retrain.py``).

Per step the same model runs twice — ``dense`` in all three towers under
``torch.no_grad()`` (the un-pruned weights are the teacher, at no extra
parameter memory; x·W are plain matmuls) and ``sparse_lora`` as the
student — and the LoRA factors take one AdamW step on

    loss = (1 − w)·CE_student + w·KL(log_softmax(z_S/T) ‖ log_softmax(z_D/T))

with ``KLDivLoss(reduction="batchmean", log_target=True)`` semantics.  Only
the LoRA factors train: every base parameter is frozen
(``requires_grad_(False)``), so autograd keeps no gradient for the frozen
towers, and the masks are buffers.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from vlm_compression_tpu_torch.common.optims import make_adamw, set_lr
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.models.layers import SparseLinear, lora_linears
from vlm_compression_tpu_torch.ops.masked_linear import merge_sparse_lora

_LORA = ("lora_a", "lora_b")


def kl_div_batchmean(student_logits, teacher_logits, T: float = 1.0):
    """Σ p_t·(log p_t − log p_s) over every element, over the batch size."""
    ls = torch.log_softmax(student_logits.float() / T, dim=-1)
    lt = torch.log_softmax(teacher_logits.float() / T, dim=-1)
    return torch.sum(lt.exp() * (lt - ls)) / student_logits.shape[0]


def kd_loss(ce_loss, student_logits, teacher_logits,
            kl_weight: float = 0.01, T: float = 2.0):
    """((1−w)·CE + w·KL, KL)."""
    kl = kl_div_batchmean(student_logits, teacher_logits, T)
    return (1.0 - kl_weight) * ce_loss + kl_weight * kl, kl


def lora_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    return {name: p for name, p in model.named_parameters()
            if name.rsplit(".", 1)[-1] in _LORA}


def freeze_base_(model: nn.Module) -> nn.Module:
    """Only the LoRA factors require gradients."""
    for name, p in model.named_parameters():
        p.requires_grad_(name.rsplit(".", 1)[-1] in _LORA)
    return model


class RessaTrainState:
    """The trainable LoRA factors (in the model, the base frozen around
    them) and their AdamW."""

    def __init__(self, model: nn.Module, opt: torch.optim.Optimizer):
        self.model, self.opt, self.step = model, opt, 0

    @classmethod
    def create(cls, model: nn.Module, weight_decay: float = 0.05,
               beta2: float = 0.999) -> "RessaTrainState":
        freeze_base_(model)
        return cls(model, make_adamw(lora_parameters(model).items(),
                                     weight_decay, beta2))

    @property
    def lora(self) -> Dict[str, nn.Parameter]:
        return lora_parameters(self.model)


def make_kd_train_step(model: nn.Module, opt: torch.optim.Optimizer,
                       kl_weight: float = 0.01, T: float = 2.0,
                       student_mode: str = "sparse_lora",
                       accum_grad_iters: int = 1) -> Callable:
    """``step(batch, lr) -> {"loss", "ce", "kl"}`` (detached 0-d tensors):
    teacher, student, gradients and one AdamW update at ``lr``.  ``batch``
    holds the model's keyword arguments.  ``accum_grad_iters`` k > 1 splits
    the batch's leading dim into k equal micro-batches and averages their
    gradients (and metrics) before the one update.  ``model``: an
    InstructBLIP-T5 or InstructBLIP-Vicuna; both take the batch's keyword
    arguments and the three mode switches."""
    accum = int(accum_grad_iters)

    def micro_step(batch, inv: float):
        with torch.no_grad():
            t_logits = model(**batch, vit_mode="dense", llm_mode="dense",
                             qformer_mode="dense")["logits"]
        out = model(**batch, vit_mode=student_mode, llm_mode=student_mode,
                    qformer_mode=student_mode)
        loss, kl = kd_loss(out["loss"], out["logits"], t_logits, kl_weight,
                           T)
        (loss * inv).backward()
        return loss.detach(), out["loss"].detach(), kl.detach()

    def step(batch: dict, lr: float) -> Dict[str, torch.Tensor]:
        opt.zero_grad(set_to_none=True)
        if accum == 1:
            loss, ce, kl = micro_step(batch, 1.0)
        else:
            b = next(iter(batch.values())).shape[0]
            if b % accum:
                raise ValueError(f"batch {b} does not split into {accum} "
                                 "equal micro-batches")
            parts = [{k: v[i * (b // accum):(i + 1) * (b // accum)]
                      for k, v in batch.items()} for i in range(accum)]
            sums = [sum(x) / accum for x in
                    zip(*(micro_step(mb, 1.0 / accum) for mb in parts))]
            loss, ce, kl = sums
        set_lr(opt, lr)
        opt.step()
        return {"loss": loss, "ce": ce, "kl": kl}

    return step


@torch.no_grad()
def merge_lora_into_params(model: nn.Module, sparse: bool = True
                           ) -> nn.Module:
    """Post-training merge, in place: ``W += (A·B·α/r) ⊙ M`` per adapted
    linear (``sparse=False``: ``W = W ⊙ M + A·B·α/r``, the densifying
    ablation); a linear without a mask merges as if all of it were kept.
    In place, unlike the JAX package's functional merge: a second copy of
    the XL weights would cost another 8 GB on the card.  The adapters stay
    (the merged model serves in ``masked`` mode, which ignores them)."""
    for _, m in lora_linears(model):
        mask = m.mask if m.mask is not None else torch.ones(
            m.kernel.shape, dtype=torch.bool, device=m.kernel.device)
        m.kernel.copy_(merge_sparse_lora(m.kernel, mask, m.lora_a, m.lora_b,
                                         m.lora_alpha / m.lora_rank,
                                         sparse=sparse))
    return model


@torch.no_grad()
def apply_masks_to_params(model: nn.Module) -> nn.Module:
    """Re-assert sparsity on the raw weights, in place: W[~mask] = 0 for
    every linear that holds a mask."""
    for m in model.modules():
        if isinstance(m, SparseLinear) and m.mask is not None:
            m.kernel.masked_fill_(~m.mask, 0)
    return model


@registry.register_task("image_text_retrain")
class ImageTextRetrainTask:
    """The KD retrain step's settings (kl_weight, T) from a run config."""

    def __init__(self, kl_weight: float = 0.01, T: float = 2.0):
        self.kl_weight = kl_weight
        self.T = T

    @classmethod
    def setup_task(cls, cfg=None, **kwargs):
        """``cfg``: a ``Config`` or a mapping shaped like a yaml."""
        run = (getattr(cfg, "run_cfg", None) or (cfg or {}).get("run")
               if cfg is not None else None)
        get = ((run.get if hasattr(run, "get")
                else lambda k, d=None: getattr(run, k, d))
               if run is not None else (lambda k, d=None: d))
        return cls(kl_weight=float(get("kl_weight", 0.01)),
                   T=float(get("T", 2.0)))

    def make_train_step(self, model, opt, student_mode="sparse_lora",
                        accum_grad_iters: int = 1):
        return make_kd_train_step(model, opt, self.kl_weight, self.T,
                                  student_mode,
                                  accum_grad_iters=accum_grad_iters)
