"""Data-derivative and activation collection (port of
``vlm_compression_tpu/compression/derivatives.py``): per-parameter mean
|∂loss/∂θ|^power (power 2: the diagonal Fisher) and per-linear activation
statistics, for the importance-based prunes of
``compression/distill_merge.py``.

Results are keyed by parameter (or linear) path tuples, the JAX package's
tree paths.  ``get_data_derivative`` differentiates with respect to every
floating parameter — T5's relative-position embeddings included, so every
self-attention of T5 runs the attention-bias gradient (the dbias kernel on
the card) — and folds each batch into fp32 accumulators in place; the JAX
package's pure fold returned a new tree per batch.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from vlm_compression_tpu_torch.models.layers import SparseLinear
from vlm_compression_tpu_torch.ops.stats import (
    init_calib_stats,
    update_calib_stats,
)

Path = Tuple[str, ...]


def _default_loss(model, batch):
    return model(**batch)["loss"]


def get_data_derivative(model: torch.nn.Module, batches: Sequence[dict],
                        loss_fn: Optional[Callable] = None,
                        power: int = 2) -> Dict[Path, torch.Tensor]:
    """Mean over batches of |∂loss/∂θ|^power, fp32, for every floating
    parameter of ``model`` (batches on the model's device).  Every
    parameter takes part whatever its ``requires_grad``; the flags are
    restored afterwards."""
    loss_fn = loss_fn or _default_loss
    named = [(tuple(n.split(".")), p) for n, p in model.named_parameters()
             if p.is_floating_point()]
    params = [p for _, p in named]
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in params]
    flags = [(p, p.requires_grad) for p in params]
    n = 0
    try:
        for p in params:
            p.requires_grad_(True)
        for b in batches:
            with torch.enable_grad():
                grads = torch.autograd.grad(loss_fn(model, b), params,
                                            allow_unused=True)
            with torch.no_grad():
                for a, g in zip(acc, grads):
                    if g is not None:   # unused: a zero gradient
                        a.add_(g.float().abs().pow_(power))
            del grads
            n += 1
    finally:
        for p, flag in flags:
            p.requires_grad_(flag)
    for a in acc:
        a.div_(max(n, 1))
    return {path: a for (path, _), a in zip(named, acc)}


@torch.no_grad()
def get_activations(model: torch.nn.Module, batches: Sequence[dict],
                    apply_kwargs: Optional[dict] = None
                    ) -> Dict[Path, torch.Tensor]:
    """Mean squared activation per input column (the Wanda ‖X‖² statistic,
    ``scaler_row``) for every linear that runs, folded by a forward
    pre-hook on each as the calibration engine does."""
    stats = {}

    def hook_for(path, lin):
        def hook(_mod, args):
            st = stats.get(path) or init_calib_stats(lin.in_features,
                                                     device=lin.kernel.device)
            stats[path] = update_calib_stats(st, args[0])
        return hook

    handles = [m.register_forward_pre_hook(hook_for(tuple(n.split(".")), m))
               for n, m in model.named_modules()
               if isinstance(m, SparseLinear)]
    try:
        for b in batches:
            model(**b, **(apply_kwargs or {}))
    finally:
        for h in handles:
            h.remove()
    return {p: s.scaler_row for p, s in stats.items()}


def convert_activation_to_importance(activations: Dict, square: bool = True
                                     ) -> Dict:
    """Per-unit importance from activation statistics: the statistic
    itself, or (square=False) its square root."""
    return {p: (a if square else torch.sqrt(torch.clamp(a, min=0.0)))
            for p, a in activations.items()}
