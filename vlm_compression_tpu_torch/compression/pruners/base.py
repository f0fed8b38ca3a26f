"""Pruner base classes (port of
``vlm_compression_tpu/compression/pruners/base.py``).

Prune specs are ``"<num_layers>-<keep_ratio>-<attn_keep>-<ffn_keep>"``
strings whose second field is the keep ratio (sparsity = 1 − keep).
Pruners operate on a model (``nn.Module``) in place.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch


def convert_spec_to_list(spec: Optional[str]):
    """'24-0.5-1.0-1.0' → (24, 0.5, 1.0, 1.0)."""
    if spec is None:
        return None
    parts = spec.split("-")
    return (int(parts[0]), float(parts[1]), float(parts[2]), float(parts[3]))


class UniformSparsity(dict):
    """sparsity_for that returns one ratio for every key."""

    def __init__(self, ratio: float):
        super().__init__()
        self.ratio = float(ratio)

    def __call__(self, key: str) -> float:
        return self.ratio

    def __missing__(self, key):
        return self.ratio


class DictSparsity:
    def __init__(self, mapping: Dict[str, float]):
        self.mapping = mapping

    def __call__(self, key: str) -> float:
        return float(self.mapping[key])


class BasePruner:
    """API: prune(lora_model=...) -> (model, sparsity_dict)."""

    pruner_name = "base"

    def __init__(self, model: torch.nn.Module, data_loader: Iterable, **kw):
        self.model = model
        self.data_loader = data_loader

    def prune(self, lora_model: bool = True):
        raise NotImplementedError


class LayerWisePrunerBase(BasePruner):
    """Shared machinery of the layer-wise pruners.  Subclasses define
    ``with_hessian`` and ``make_mask_fn(lora_model, tower)``."""

    with_hessian = False
    owl_m: float = 5.0  # OWL outlier threshold (score_method owl_*)

    def __init__(self, model, data_loader,
                 prune_spec: Optional[str] = None,
                 t5_prune_spec: Optional[str] = None,
                 vit_prune_spec: Optional[str] = None,
                 num_samples: int = 64,
                 prune_n: int = 0, prune_m: int = 0,
                 sparsity_ratio_granularity: Optional[str] = None,
                 max_sparsity_per_layer: float = 0.8,
                 score_method: str = "obd_avg",
                 num_data_first_stage: int = 32,
                 num_noise: int = 1,
                 noise_eps: float = 1e-3,
                 sparsity_dict: Optional[Dict[str, float]] = None,
                 t5_model_prefix: str = "t5_model",
                 vit_model_prefix: str = "visual_encoder",
                 **kw):
        super().__init__(model, data_loader)
        self.prune_spec = prune_spec
        self.t5_prune_spec = t5_prune_spec
        self.vit_prune_spec = vit_prune_spec
        self.num_samples = num_samples
        self.prune_n, self.prune_m = prune_n, prune_m
        self.sparsity_ratio_granularity = sparsity_ratio_granularity
        self.max_sparsity_per_layer = max_sparsity_per_layer
        self.score_method = score_method
        self.num_data_first_stage = num_data_first_stage
        self.num_noise = num_noise
        self.noise_eps = noise_eps
        self.sparsity_dict = sparsity_dict
        self.t5_model_prefix = t5_model_prefix
        self.vit_model_prefix = vit_model_prefix
        # method knobs are class attributes; accept overrides by name
        for k, v in kw.items():
            if hasattr(type(self), k):
                setattr(self, k, v)

    def batches(self) -> Sequence[dict]:
        """Up to num_samples calibration samples, as provided batches,
        moved to the model's device."""
        device = next(self.model.parameters()).device
        out, n = [], 0
        for b in self.data_loader:
            out.append({k: (torch.as_tensor(v).to(device)
                            if hasattr(v, "shape") else v)
                        for k, v in b.items()})
            n += next(iter(b.values())).shape[0]
            if n >= self.num_samples:
                break
        return out

    def make_mask_fn(self, lora_model: bool, tower: str = "llm"):
        raise NotImplementedError

    def get_sparsity(self, original_sparsity: float,
                     granularity: Optional[str] = None):
        """Uniform, dict, or the non-uniform ``LayerSparsity`` allocation
        at the given granularity (scored on the first
        ``num_data_first_stage`` samples)."""
        if self.sparsity_dict:
            return DictSparsity(self.sparsity_dict)
        if granularity in (None, "none"):
            return UniformSparsity(original_sparsity)
        from vlm_compression_tpu_torch.compression.allocator import (
            LayerSparsity,
        )

        alloc = LayerSparsity(
            model=self.model,
            data_loader=self.data_loader,
            original_sparsity=original_sparsity,
            granularity=granularity,
            max_sparsity_per_layer=self.max_sparsity_per_layer,
            score_method=self.score_method,
            num_data=self.num_data_first_stage,
            num_noise=self.num_noise,
            noise_eps=self.noise_eps,
            prefixes=self._allocation_prefixes(),
            owl_m=self.owl_m,
        )
        return DictSparsity(alloc.return_sparsity())

    def _allocation_prefixes(self):
        """Top-level prefixes whose kernels take part in the allocation
        (None: all)."""
        return None
