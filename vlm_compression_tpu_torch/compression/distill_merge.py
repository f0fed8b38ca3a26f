"""Unstructured importance pruning (the ``unstrct`` distillation inits;
port of that part of ``vlm_compression_tpu/compression/distill_merge.py``).
The block merging of that module is not ported yet."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

Path = Tuple[str, ...]


@torch.no_grad()
def prune_by_importance(module: torch.nn.Module,
                        scores: Dict[Path, torch.Tensor],
                        keep_ratio: float
                        ) -> Tuple[torch.nn.Module, Dict[Path, torch.Tensor]]:
    """Zero the round(size·(1 − keep_ratio)) lowest-importance entries of
    each scored parameter of ``module`` (keys: parameter paths relative to
    it), in place; returns (module, {path: the zeroed flat indices, sorted,
    int32}).  The select is a per-leaf k-smallest (``torch.topk``) on the
    parameter's own device; which of tied scores go is unspecified, as in
    the JAX package's ``np.argpartition``."""
    params = dict(module.named_parameters())
    pruned = {}
    for path, imp in scores.items():
        leaf = params[".".join(path)]
        flat_imp = torch.as_tensor(imp).to(device=leaf.device,
                                           dtype=torch.float32).reshape(-1)
        k_prune = int(round(flat_imp.numel() * (1.0 - keep_ratio)))
        if k_prune <= 0:
            continue
        idx = torch.topk(flat_imp, k_prune, largest=False,
                         sorted=False).indices
        leaf.view(-1)[idx] = 0
        pruned[path] = torch.sort(idx).values.to(torch.int32)
    return module, pruned


def count_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def count_nonzero(module: torch.nn.Module) -> int:
    """Non-zero entries of the floating parameters."""
    return sum(int(torch.count_nonzero(p)) for p in module.parameters()
               if p.is_floating_point())
