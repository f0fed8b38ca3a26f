"""LR schedules + the AdamW factory (port of
``vlm_compression_tpu/common/optims.py``).

Each scheduler is a plain function of (epoch, step) → lr, as in the JAX
package; the caller sets the value on the optimizer before each step
(``set_lr``).  ``make_adamw`` is ``torch.optim.AdamW`` with the JAX
package's decay / no-decay split: optax's ``scale_by_adam →
add_decayed_weights → scale(−lr)`` is the same update as torch's decoupled
decay, p ← p − lr·(m̂ / (√v̂ + ε) + wd·p), up to rounding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable, Tuple

import torch

from vlm_compression_tpu_torch.common.registry import registry


def _warmup(init_lr: float, start_lr: float, steps: int, cur_step: int):
    return min(init_lr, start_lr + (init_lr - start_lr) * cur_step
               / max(steps, 1))


@registry.register_lr_scheduler("linear_warmup_cosine_lr")
@dataclasses.dataclass
class LinearWarmupCosineLRScheduler:
    """Step-wise linear warmup during epoch 0, epoch-wise cosine after."""

    max_epoch: int
    min_lr: float
    init_lr: float
    warmup_steps: int = 0
    warmup_start_lr: float = -1.0

    def __post_init__(self):
        if self.warmup_start_lr < 0:
            self.warmup_start_lr = self.init_lr

    def __call__(self, cur_epoch: int, cur_step: int) -> float:
        if cur_epoch == 0:
            return _warmup(self.init_lr, self.warmup_start_lr,
                           self.warmup_steps, cur_step)
        return (self.init_lr - self.min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * cur_epoch / self.max_epoch)
        ) + self.min_lr


@registry.register_lr_scheduler("linear_warmup_step_lr")
@dataclasses.dataclass
class LinearWarmupStepLRScheduler:
    """Warmup then exponential epoch decay."""

    max_epoch: int
    min_lr: float
    init_lr: float
    decay_rate: float = 1.0
    warmup_steps: int = 0
    warmup_start_lr: float = -1.0

    def __post_init__(self):
        if self.warmup_start_lr < 0:
            self.warmup_start_lr = self.init_lr

    def __call__(self, cur_epoch: int, cur_step: int) -> float:
        if cur_epoch == 0:
            return _warmup(self.init_lr, self.warmup_start_lr,
                           self.warmup_steps, cur_step)
        return max(self.min_lr, self.init_lr * self.decay_rate ** cur_epoch)


def make_lr_scheduler(run_cfg: Any):
    """Build from a run-config namespace or dict."""
    get = (run_cfg.get if hasattr(run_cfg, "get")
           else lambda k, d=None: getattr(run_cfg, k, d))
    name = get("lr_sched", "linear_warmup_cosine_lr")
    cls = registry.get_lr_scheduler_class(name)
    kw = dict(
        max_epoch=int(get("max_epoch", 1)),
        min_lr=float(get("min_lr", 0.0)),
        init_lr=float(get("init_lr", 1e-4)),
        warmup_steps=int(get("warmup_steps", 0)),
        warmup_start_lr=float(get("warmup_lr", -1.0)),
    )
    if name == "linear_warmup_step_lr":
        kw["decay_rate"] = float(get("lr_decay_rate", 1.0))
    return cls(**kw)


def no_decay(name: str, param: torch.Tensor) -> bool:
    """No weight decay for parameters of rank < 2 (biases, norm scales) or
    named ``bias``, ``scale`` or ``embedding_ln``."""
    return param.ndim < 2 or name.rsplit(".", 1)[-1] in (
        "bias", "scale", "embedding_ln")


def make_adamw(named_params: Iterable[Tuple[str, torch.Tensor]],
               weight_decay: float = 0.05,
               beta2: float = 0.999) -> torch.optim.AdamW:
    """AdamW (betas (0.9, beta2), eps 1e-8, decoupled decay) over the
    given parameters, in a decay and a no-decay group.  The lr starts at 0:
    the step sets it from the scheduler (``set_lr``)."""
    decay, keep = [], []
    for name, p in named_params:
        (keep if no_decay(name, p) else decay).append(p)
    groups = [g for g in ({"params": decay, "weight_decay": weight_decay},
                          {"params": keep, "weight_decay": 0.0})
              if g["params"]]
    return torch.optim.AdamW(groups, lr=0.0, betas=(0.9, beta2), eps=1e-8)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = float(lr)
