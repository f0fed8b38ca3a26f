"""Global magnitude-class pruners for the joint V+L model (port of
``vlm_compression_tpu/compression/pruners/global_pruner.py``).

One-shot or iterative pruning across both towers with the schedule
``p_i = p^(iteration/i)``, thresholded globally over every score, per
model (ViT, T5), or per layer; pruned weights are zeroed in place and the
keep-masks set (``models/layers.set_mask``), so the sparse forward stays
mask-driven.

The threshold is the k-th smallest score, as ``jnp.sort(flat)[k - 1]``
gives it.  Over several leaves it is found by selection, not by sorting a
concatenation: at InstructBLIP-FlanT5-XL width the scores alone are about
15 GB of fp32, and a sort of their concatenation would not fit on the card
beside the model.  ``kth_smallest`` runs a radix select one bit a pass
over the order-preserving integer image of the fp32 scores, each pass a
count by reduction over the leaves, on the scores' device; one leaf (the
per-layer mode) is sorted.  ``v > threshold`` keeps, as in the JAX
package.

Registered: ``blipt5_mag_pruner`` (the SIGNED weight, as the reference
scores it: the most negative weights prune first), ``blipt5_absmag_pruner``
(|W|), ``blipt5_rand_pruner``, ``blipt5_aobd_pruner`` (|W|·mean|g|) and
``blipt5_mezo_pruner`` (one zeroth-order scalar per layer, so a global
threshold keeps or drops whole layers; under the per-layer mode a (1, 1)
score prunes int(p·1) = 0 entries and every layer is kept).

``rand`` draws each leaf from a ``torch.Generator`` on the model's device
seeded from ``SeedSequence([seed, i])``: the JAX package draws from
``jax.random.fold_in(key(seed), i)``, which torch cannot reproduce, so the
two give other draws from one seed.  MeZO's z comes from generators the
same way unless a ``noise_fn`` supplies it.
"""

from __future__ import annotations

import logging
from typing import Dict, Sequence

import numpy as np
import torch

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.compression.allocator import (
    mezo_layer_scalars,
    model_loss,
    seeded_normal,
    select_prunable_keys,
)
from vlm_compression_tpu_torch.compression.pruners.base import (
    LayerWisePrunerBase,
    convert_spec_to_list,
)
from vlm_compression_tpu_torch.models.layers import set_mask

_LOW31 = 0x7FFFFFFF


def _key(v: float) -> int:
    """The order-preserving int64 image in [0, 2³²) of one fp32 value."""
    i = int(torch.tensor(v, dtype=torch.float32).view(torch.int32))
    return (i ^ ((i >> 31) & _LOW31)) + (1 << 31)


def _value_of(key: torch.Tensor) -> torch.Tensor:
    """The fp32 value whose image is ``key`` (int64, any shape)."""
    s = (key - (1 << 31)).to(torch.int32)
    return (s ^ ((s >> 31) & _LOW31)).view(torch.float32)


def kth_smallest(leaves: Sequence[torch.Tensor], k: int) -> torch.Tensor:
    """The k-th smallest (1-based) of all the leaves' values, as a 0-d fp32
    tensor on their device (−inf for k ≤ 0): equal in value to
    ``sort(concatenation)[k - 1]``.

    One leaf is sorted (a few launches; a copy of one leaf).  Several are
    never concatenated: a radix select one bit a pass, 32 halvings of an
    interval of the values' order-preserving integer image, each pass
    counting the values at or below the midpoint's value, leaf by leaf,
    with a reduction (no atomics, so no contention on the tied values that
    bf16 weights give).  The interval and the counts stay on the device:
    no host sync."""
    dev = leaves[0].device
    if k <= 0:
        return torch.tensor(float("-inf"), device=dev)
    if len(leaves) == 1:
        return torch.sort(leaves[0].reshape(-1).float()).values[k - 1]
    lo = torch.tensor(_key(float("-inf")), dtype=torch.int64, device=dev)
    hi = torch.tensor(_key(float("inf")), dtype=torch.int64, device=dev)
    for _ in range(32):
        mid = lo + (hi - lo) // 2
        thr = _value_of(mid)
        count = torch.stack([torch.count_nonzero(v <= thr)
                             for v in leaves]).sum()
        enough = count >= k
        hi = torch.where(enough, mid, hi)
        lo = torch.where(enough, lo, mid + 1)
    return _value_of(lo)


def global_mask(scores: Dict[str, torch.Tensor], p: float,
                max_sparsity_per_layer: float = 1.0
                ) -> Dict[str, torch.Tensor]:
    """One threshold over every score; each key's top (1 − max_sparsity)
    share is promoted to fp32 max first, so it survives."""
    promoted = {}
    fmax = torch.finfo(torch.float32).max
    for key, v in scores.items():
        v = v.float()
        num_protect = int(v.numel() * (1.0 - max_sparsity_per_layer))
        if num_protect > 0:
            thr = kth_smallest([v], v.numel() - num_protect + 1)
            v = torch.where(v >= thr, fmax, v)
        promoted[key] = v
    k = int(p * sum(v.numel() for v in promoted.values()))
    thr = kth_smallest(list(promoted.values()), k)
    return {key: v > thr for key, v in promoted.items()}


def layerwise_mask(scores: Dict[str, torch.Tensor], p: float
                   ) -> Dict[str, torch.Tensor]:
    """A threshold per layer."""
    out = {}
    for key, v in scores.items():
        v = v.float()
        out[key] = v > kth_smallest([v], int(p * v.numel()))
    return out


class BlipT5GlobalPruner(LayerWisePrunerBase):
    """Base: the iterative schedule and the masking modes; subclasses give
    the scores, keyed by the '/'-joined module paths."""

    pruner_name = "blipt5_global_pruner"

    def __init__(self, model, data_loader, is_global: bool = False,
                 prune_per_model: bool = False, iteration: int = 1,
                 seed: int = 0, **kw):
        super().__init__(model, data_loader, **kw)
        self.is_global = is_global
        self.prune_per_model = prune_per_model
        self.iteration = iteration
        self.seed = seed

    def compute_importance(self, keys, batches) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _kernel(self, key) -> torch.nn.Parameter:
        return self.model.get_submodule(".".join(key)).kernel

    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    @torch.no_grad()
    def prune(self, lora_model: bool = True):
        if self.t5_prune_spec is None or self.vit_prune_spec is None:
            return self.model, None
        vit_keep = convert_spec_to_list(self.vit_prune_spec)[1]
        t5_keep = convert_spec_to_list(self.t5_prune_spec)[1]
        # only meaningful when the two ratios agree, as in the reference
        target_sparsity = 1.0 - min(vit_keep, t5_keep)
        keys = select_prunable_keys(
            self.model, prefixes=(self.vit_model_prefix, self.t5_model_prefix))
        batches = self.batches()

        masks = None
        for i in range(1, self.iteration + 1):
            p_i = target_sparsity ** (self.iteration / i)
            imp = self.compute_importance(keys, batches)
            if masks is not None:
                imp = {k: imp[k] * masks[k].to(imp[k].dtype) for k in imp}

            if self.is_global and not self.prune_per_model:
                masks = global_mask(imp, p_i, 1.0)
            elif self.is_global:
                vis = {k: v for k, v in imp.items()
                       if k.startswith(self.vit_model_prefix)}
                lang = {k: v for k, v in imp.items()
                        if k.startswith(self.t5_model_prefix)}
                masks = {**global_mask(vis, p_i, 1.0),
                         **global_mask(lang, p_i, 1.0)}
            else:
                masks = layerwise_mask(imp, p_i)
            del imp

            for key in keys:
                lin = self.model.get_submodule(".".join(key))
                m = masks["/".join(key)].expand(lin.kernel.shape).contiguous()
                lin.kernel.masked_fill_(~m, 0)
                set_mask(lin, m)
            logging.info("%s: step %d target sparsity %.4f",
                         self.pruner_name, i, p_i)
        return self.model, None


@registry.register_pruner("blipt5_mag_pruner")
class BlipT5MagPruner(BlipT5GlobalPruner):
    """The SIGNED weight value, as the reference scores it: the most
    negative weights prune first."""

    pruner_name = "blipt5_mag_pruner"

    def compute_importance(self, keys, batches):
        return {"/".join(k): self._kernel(k).detach().to(torch.float32,
                                                         copy=True)
                for k in keys}


@registry.register_pruner("blipt5_absmag_pruner")
class BlipT5AbsMagPruner(BlipT5GlobalPruner):
    """Magnitude pruning by |W|."""

    pruner_name = "blipt5_absmag_pruner"

    def compute_importance(self, keys, batches):
        return {"/".join(k): torch.abs(self._kernel(k).detach().float())
                for k in keys}


@registry.register_pruner("blipt5_rand_pruner")
class BlipT5RandPruner(BlipT5GlobalPruner):
    """Standard normal scores, leaf i drawn from a generator seeded from
    ``SeedSequence([seed, i])``."""

    pruner_name = "blipt5_rand_pruner"

    def compute_importance(self, keys, batches):
        dev = self._device()
        return {"/".join(k): seeded_normal(self._kernel(k).shape,
                                           (self.seed, i), dev)
                for i, k in enumerate(keys)}


@registry.register_pruner("blipt5_aobd_pruner")
class BlipT5AObdPruner(BlipT5GlobalPruner):
    """First-order |W|·mean|g| over the calibration batches, whole score
    tensors (a global threshold needs every entry).  Autograd is asked for
    the prunable kernels only: ``requires_grad`` is switched on for those
    alone and every flag restored after, so no other gradient (no
    attention-bias gradient) is formed.  |g| accumulates in fp32."""

    pruner_name = "blipt5_aobd_pruner"

    def compute_importance(self, keys, batches):
        kernels = [self._kernel(k) for k in keys]
        flags = [(p, p.requires_grad) for p in self.model.parameters()]
        acc = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               for w in kernels]
        try:
            for p, _ in flags:
                p.requires_grad_(False)
            for w in kernels:
                w.requires_grad_(True)
            for b in batches:
                with torch.enable_grad():
                    grads = torch.autograd.grad(model_loss(self.model, b),
                                                kernels)
                for a, g in zip(acc, grads):
                    a.add_(torch.abs(g.float()))
                del grads
        finally:
            for p, flag in flags:
                p.requires_grad_(flag)
        nb = max(len(batches), 1)
        out = {}
        for k, w, a in zip(keys, kernels, acc):
            out["/".join(k)] = a.div_(nb).mul_(torch.abs(w.detach().float()))
        return out


@registry.register_pruner("blipt5_mezo_pruner")
class BlipT5MezoPruner(BlipT5GlobalPruner):
    """Zeroth-order: one scalar Σ|projected gradient| per layer over the
    sample budget (``allocator.mezo_layer_scalars``), so a threshold keeps
    or drops whole layers."""

    pruner_name = "blipt5_mezo_pruner"
    # noise_fn((leaf, batch, noise), key, shape) -> ndarray: replays
    # external Gaussians (the parity tests)
    noise_fn = None

    def compute_importance(self, keys, batches):
        dev = self._device()

        def z_fn(tag, k, shape):
            if self.noise_fn is not None:
                return torch.as_tensor(np.asarray(
                    self.noise_fn(tag, "/".join(k), tuple(shape)),
                    np.float32), device=dev)
            return seeded_normal(shape, (self.seed, *tag), dev)

        scalars = mezo_layer_scalars(
            self.model, keys, batches, model_loss, eps=self.noise_eps,
            num_noise=self.num_noise, num_samples=self.num_samples,
            z_fn=z_fn)
        return {"/".join(k): torch.full((1, 1), v, dtype=torch.float32,
                                        device=dev)
                for k, v in scalars.items()}
