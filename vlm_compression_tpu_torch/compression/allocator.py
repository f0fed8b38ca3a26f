"""LayerSparsity — non-uniform sparsity allocation across layer groups
(port of ``vlm_compression_tpu/compression/allocator.py``).

Given a global sparsity budget, score layer *groups* (per-model /
per-block / per-layer granularity) with first-order gradients (``obd`` =
W²·ḡ², ``aobd`` = W²·mean|g| — the reference's dispatch precedence quirk,
see ``_score_first_order``; ``aobd-strict`` = the literal |W|·|ḡ|;
``gradient`` = |ḡ|), outlier counts (``owl``) or zeroth-order MeZO
estimators (seeded Gaussian perturbations, projected gradient
``(loss₊ − loss₋)/2ε``), then waterfill parameters-to-keep across groups
proportionally to score, clamped by ``max_sparsity_per_layer``
(``compute_the_sparsity_per_group``).

The model is an ``nn.Module`` whose prunable linears are the
``SparseLinear`` kernels inside ``blocks_*`` modules.  Keys are their
module paths as tuples; the returned dict is keyed by the '/'-joined
paths the calibration engine asks ``sparsity_for`` for.

  * The first-order scorer asks autograd for the prunable kernels only: it
    switches ``requires_grad`` on for those tensors alone (and restores
    every flag after), so no other gradient is formed — in particular no
    attention-bias gradient, which on the TPU XLA removed as dead code.
    Only group sums matter, and every first-order variant factorizes over
    batches, so each batch folds into one fp32 scalar per key.
  * MeZO perturbs the kernels in place and restores them from a saved copy
    afterwards.  Its noise comes from ``torch.Generator``s seeded per
    (seed, batch, leaf) or (seed, leaf, batch, noise), regenerated for each
    use.  They do not give ``jax.random``'s numbers: parity with the JAX
    package goes through the ``noise_fn`` hook, as the JAX package's own
    reference-parity tests do.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vlm_compression_tpu_torch.models.layers import SparseLinear

Path = Tuple[str, ...]


# ---------------------------------------------------------------------------
# key selection + grouping
# ---------------------------------------------------------------------------


def select_prunable_keys(model: torch.nn.Module,
                         prefixes: Optional[Sequence[str]] = None
                         ) -> List[Path]:
    """2-D kernels of the linears inside ``blocks_*`` modules, under the
    given top-level prefixes (all when None).  Returns sorted module
    paths."""
    out = []
    for name, mod in model.named_modules():
        if not isinstance(mod, SparseLinear) or mod.kernel.ndim != 2:
            continue
        path = tuple(name.split("."))
        if not any(p.startswith("blocks_") for p in path):
            continue
        if prefixes and not any(path[0] == p or path[0].startswith(p)
                                for p in prefixes):
            continue
        out.append(path)
    return sorted(out)


def build_group_mapping(keys: Sequence[Path], granularity: str
                        ) -> Dict[Path, str]:
    """granularity ∈ {model, block, layer}."""
    def group(path: Path) -> str:
        if granularity == "model":
            return path[0]
        if granularity == "layer":
            return "/".join(path)
        if granularity == "block":
            for i, p in enumerate(path):
                if p.startswith("blocks_"):
                    return "/".join(path[: i + 1])
            return path[0]
        raise NotImplementedError(granularity)

    return {k: group(k) for k in keys}


# ---------------------------------------------------------------------------
# group allocation (NumPy — O(groups), not device work)
# ---------------------------------------------------------------------------


def compute_the_sparsity_per_group(
    total_parameters_to_keep: int,
    group_scores: Dict[str, float],
    group_num_parameters: Dict[str, int],
    max_sparsity_per_layer: float = 0.8,
    max_iters: int = 100,
    reference_fixups: bool = False,
) -> Dict[str, float]:
    """Iterative proportional allocation of params-to-keep.

    ``reference_fixups=True`` reproduces the reference's over-total
    behaviour bit for bit: its "remove extra parameters" branch has a
    ``+=`` where only ``-=`` terminates, so it keeps MORE than the budget.
    The default subtracts, so the budget is hit exactly."""
    names = list(group_scores)
    dt = np.float32 if reference_fixups else np.float64
    scores = np.array([max(float(group_scores[n]), 0.0) for n in names], dt)
    nparams = np.array([int(group_num_parameters[n]) for n in names],
                       np.int64)
    floor_keep = np.ceil(nparams * (1.0 - max_sparsity_per_layer)).astype(
        np.int64)
    keep = floor_keep.copy()
    total_keep = int(min(total_parameters_to_keep, nparams.sum()))

    for _ in range(max_iters):
        if keep.sum() >= total_keep:
            break
        total_ratio = scores.sum(dtype=dt)
        if total_ratio <= 0:
            # no scored capacity left: spread over whatever has room
            need = total_keep - keep.sum()
            for i in np.argsort(-(nparams - keep), kind="stable"):
                can = min(need, int(nparams[i] - keep[i]))
                keep[i] += can
                need -= can
                if need <= 0:
                    break
            break
        rest = total_keep - keep.sum()
        add = np.ceil((scores / total_ratio) * dt(rest)).astype(np.int64)
        keep = keep + add
        scores[keep >= nparams] = 0.0
        keep = np.minimum(keep, nparams)

    # exact-total fixups
    if keep.sum() < total_keep:
        need = total_keep - keep.sum()
        for i in np.where(nparams - keep > 0)[0]:
            can = min(need, int(nparams[i] - keep[i]))
            keep[i] += can
            need -= can
            if need <= 0:
                break
    elif keep.sum() > total_keep:
        over = keep.sum() - total_keep
        for i in np.argsort(-keep, kind="stable"):
            # reference remove-branch floor: int() truncation, not ceil
            floor_i = (int(nparams[i] * (1.0 - max_sparsity_per_layer))
                       if reference_fixups else floor_keep[i])
            can = min(over, int(keep[i]) - floor_i)
            if reference_fixups:
                keep[i] += can      # the reference's += typo, verbatim
            else:
                keep[i] -= can
            over -= can
            if over <= 0:
                break

    out = {}
    for n, k, m in zip(names, keep, nparams):
        out[n] = float(np.clip(1.0 - k / max(m, 1), 0.0, 1.0))
    return out


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------


def model_loss(model, batch):
    return model(**batch)["loss"]


def seeded_normal(shape, tag: Sequence[int], device) -> torch.Tensor:
    """A replayable standard normal on ``device``: the generator's seed is
    drawn from ``SeedSequence(tag)``."""
    seed = int(np.random.SeedSequence(list(tag)).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(tuple(shape), generator=gen, device=device)


@torch.no_grad()
def mezo_layer_scalars(model: torch.nn.Module, keys: Sequence[Path],
                       batches: Sequence[dict], loss_fn: Callable, *,
                       eps: float, num_noise: int, num_samples: int,
                       z_fn: Callable, abs_each: bool = True
                       ) -> Dict[Path, float]:
    """One zeroth-order scalar per kernel: Σ over batches of |Σ over
    noises of the projected gradient (loss(W + εz) − loss(W − εz)) / 2ε|,
    each noise's |·| first when ``abs_each``.  The sample budget counts
    one batch per noise evaluation, as the reference does (bs 1, 4
    noises, 8 samples means two batches).  ``z_fn((leaf, batch, noise),
    key, shape)`` gives z.  Each kernel is perturbed in place and restored
    from a saved copy."""
    out = {}
    for li, k in enumerate(keys):
        w = model.get_submodule(".".join(k)).kernel
        orig = w.detach().clone()
        acc = 0.0
        accum = 0
        try:
            for bi, b in enumerate(batches):
                if accum >= num_samples:
                    break
                per = 0.0
                for ni in range(num_noise):
                    if accum >= num_samples:
                        break
                    z = z_fn((li, bi, ni), k, w.shape)
                    losses = []
                    for scale in (+1.0, -1.0):
                        w.copy_((orig.float() + scale * eps * z).to(w.dtype))
                        losses.append(loss_fn(model, b))
                    pg = float((losses[0] - losses[1]) / (2.0 * eps))
                    per += abs(pg) if abs_each else pg
                    accum += int(next(iter(b.values())).shape[0])
                acc += abs(per)
        finally:
            w.copy_(orig)
        out[k] = acc
    return out


class LayerSparsity:
    """score_method = "<compute>_<aggregate>": compute ∈ {obd, aobd,
    aobd-strict, gradient, owl, mezo-{obd,aobd,gradient}, lmezo-*,
    olmezo-*}, aggregate ∈ {sum, avg}.

    ``noise_fn(tag, key, shape) -> ndarray``, when given, supplies every
    MeZO perturbation z (tag = the batch index for mezo-diff, (leaf, batch,
    noise) for the per-layer variants); the injected mezo-diff path also
    applies the per-batch drift to the live weights before the next batch,
    as the reference does."""

    def __init__(self, model: torch.nn.Module, data_loader,
                 original_sparsity: float,
                 granularity: str = "block",
                 max_sparsity_per_layer: float = 0.8,
                 score_method: str = "obd_avg",
                 num_data: int = 32,
                 num_noise: int = 1,
                 noise_eps: float = 1e-3,
                 prefixes: Optional[Sequence[str]] = None,
                 loss_fn: Optional[Callable] = None,
                 seed: int = 0,
                 owl_m: float = 5.0,
                 noise_fn: Optional[Callable] = None,
                 reference_fixups: bool = False):
        assert max_sparsity_per_layer >= original_sparsity, (
            "max_sparsity_per_layer must cover the budget")
        self.model = model
        self.data_loader = data_loader
        self.original_sparsity = float(original_sparsity)
        self.granularity = granularity
        self.max_sparsity_per_layer = float(max_sparsity_per_layer)
        self.score_compute, _, agg = score_method.partition("_")
        self.score_aggregate = agg or "avg"
        self.num_data = num_data
        self.num_noise = num_noise
        self.noise_eps = float(noise_eps)
        self.prefixes = prefixes
        self.seed = seed
        self.owl_m = float(owl_m)
        self.noise_fn = noise_fn
        self.reference_fixups = reference_fixups
        self.loss_fn = loss_fn or model_loss

    # -- plumbing ------------------------------------------------------
    def _device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _batches(self, limit=None) -> List[dict]:
        """Batches of the loader until ``limit`` samples, on the model's
        device."""
        limit = limit or self.num_data
        dev = self._device()
        n, out = 0, []
        for b in self.data_loader:
            out.append({k: torch.as_tensor(v).to(dev)
                        if hasattr(v, "shape") else v for k, v in b.items()})
            n += next(iter(b.values())).shape[0]
            if n >= limit:
                break
        return out

    def _kernel(self, key: Path) -> torch.nn.Parameter:
        return self.model.get_submodule(".".join(key)).kernel

    def _z(self, shape, tag) -> torch.Tensor:
        """A replayable standard normal seeded from (seed, *tag)."""
        return seeded_normal(shape, (self.seed, *tag), self._device())

    def _injected(self, tag, key: Path, shape) -> torch.Tensor:
        return torch.as_tensor(
            np.asarray(self.noise_fn(tag, "/".join(key), tuple(shape)),
                       np.float32), device=self._device())

    # -- public API ----------------------------------------------------
    def return_sparsity(self) -> Dict[str, float]:
        keys = select_prunable_keys(self.model, self.prefixes)
        mapping = build_group_mapping(keys, self.granularity)

        if self.score_compute == "owl":
            sums = self._score_owl(keys)
        elif self.score_compute.startswith("mezo"):
            sums = self._score_mezo_diff(keys)
        elif self.score_compute.startswith(("lmezo", "olmezo")):
            sums = self._score_mezo_layer(keys)
        else:
            sums = self._score_first_order(keys)

        nparams = {k: self._kernel(k).numel() for k in keys}
        group_scores: Dict[str, float] = {}
        group_np: Dict[str, int] = {}
        for k in keys:
            g = mapping[k]
            group_scores[g] = group_scores.get(g, 0.0) + sums[k]
            group_np[g] = group_np.get(g, 0) + nparams[k]
        if self.score_aggregate == "avg":
            for g in group_scores:
                group_scores[g] /= group_np[g]

        total_keep = int(sum(nparams.values())
                         * (1.0 - self.original_sparsity))
        group_sparsity = compute_the_sparsity_per_group(
            total_keep, group_scores, group_np, self.max_sparsity_per_layer,
            reference_fixups=self.reference_fixups)

        result = {"/".join(k): group_sparsity[mapping[k]] for k in keys}
        kept = sum((1.0 - result["/".join(k)]) * nparams[k] for k in keys)
        logging.info("LayerSparsity: keep %.0f / target %d params",
                     kept, total_keep)
        return result

    # -- first-order scorer --------------------------------------------
    def _score_first_order(self, keys) -> Dict[Path, float]:
        compute = self.score_compute
        kernels = [self._kernel(k) for k in keys]
        flags = [(p, p.requires_grad) for p in self.model.parameters()]
        sums = [0.0] * len(keys)
        batches = self._batches()
        try:
            for p, _ in flags:
                p.requires_grad_(False)
            for w in kernels:
                w.requires_grad_(True)
            for b in batches:
                with torch.enable_grad():
                    grads = torch.autograd.grad(self.loss_fn(self.model, b), kernels)
                with torch.no_grad():
                    per = []
                    for w, g in zip(kernels, grads):
                        w, g = w.float(), g.float()
                        if compute == "obd":
                            per.append(torch.sum(w * w * g * g))
                        elif compute == "aobd":
                            # reference precedence quirk: its composition
                            # dispatch tests `"obd" in score_compute` first,
                            # which "aobd" also matches — so first-order
                            # aobd is w²·mean|g|; "aobd-strict" below gives
                            # the literal |W|·|ḡ|
                            per.append(torch.sum(w * w * torch.abs(g)))
                        elif compute == "aobd-strict":
                            per.append(torch.sum(torch.abs(w) * torch.abs(g)))
                        else:  # gradient
                            per.append(torch.sum(torch.abs(g)))
                    del grads
                for i, v in enumerate(torch.stack(per).tolist()):
                    sums[i] += v
        finally:
            for p, flag in flags:
                p.requires_grad_(flag)
        nb = max(len(batches), 1)
        return {k: s / nb for k, s in zip(keys, sums)}

    # -- OWL scorer (Outlier Weighed Layerwise sparsity, Yin et al. 2024) --
    @torch.no_grad()
    def _score_owl(self, keys) -> Dict[Path, float]:
        """Group score = count of outlier entries of the Wanda metric
        A = |W|·sqrt(E‖X‖²): entries with A > owl_m·mean(A) per layer.  The
        "avg" aggregate divides by group size (outlier fractions)."""
        ssq: Dict[Path, torch.Tensor] = {}

        def hook_for(k):
            def hook(_mod, args):
                x = args[0].float()
                s = torch.sum(x * x, dim=tuple(range(x.ndim - 1)))
                ssq[k] = s if k not in ssq else ssq[k] + s
            return hook

        handles = [self.model.get_submodule(".".join(k))
                   .register_forward_pre_hook(hook_for(k)) for k in keys]
        try:
            for b in self._batches():
                self.model(**b)
        finally:
            for h in handles:
                h.remove()
        out = {}
        for k in keys:
            w = torch.abs(self._kernel(k).float()).T
            a = w * torch.sqrt(ssq[k])[None, :]
            out[k] = float(torch.sum(a > self.owl_m * torch.mean(a)))
        return out

    # -- MeZO full-model drift scorer ----------------------------------
    @torch.no_grad()
    def _score_mezo_diff(self, keys) -> Dict[Path, float]:
        eps = self.noise_eps
        kernels = {k: self._kernel(k) for k in keys}
        orig = {k: w.detach().clone() for k, w in kernels.items()}
        lr = 1e-3 / sum(w.numel() for w in kernels.values())
        drift = {k: torch.zeros(w.shape, dtype=torch.float32,
                                device=w.device) for k, w in kernels.items()}
        injected = self.noise_fn is not None
        # the injected path drifts the live weights batch by batch; the
        # seeded one scores every batch at the original weights
        live = {k: w.clone() for k, w in orig.items()} if injected else orig
        batches = self._batches()
        try:
            for i, b in enumerate(batches):
                if injected:
                    zs = {k: self._injected(i, k, w.shape)
                          for k, w in kernels.items()}

                def z_of(li, k):
                    return zs[k] if injected else self._z(
                        kernels[k].shape, (0, i, li))

                losses = []
                for scale in (+eps, -eps):
                    for li, k in enumerate(keys):
                        w = kernels[k]
                        w.copy_((live[k].float() + scale * z_of(li, k))
                                .to(w.dtype))
                    losses.append(self.loss_fn(self.model, b))
                pg = (losses[0] - losses[1]) / (2.0 * eps)
                for li, k in enumerate(keys):
                    step = pg * z_of(li, k) * lr
                    drift[k] -= step
                    if injected:
                        live[k] = (live[k].float() + (-1.0) * step).to(
                            live[k].dtype)
        finally:
            for k, w in kernels.items():
                w.copy_(orig[k])
        nb = max(len(batches), 1)
        sums = {}
        for k in keys:
            d = drift[k] / nb
            w = orig[k].float()
            if self.score_compute == "mezo-obd":
                sums[k] = float(torch.sum(w * w * d * d))
            elif self.score_compute == "mezo-aobd":
                sums[k] = float(torch.sum(torch.abs(w) * torch.abs(d)))
            else:  # mezo-gradient
                sums[k] = float(torch.sum(torch.abs(d)))
        return sums

    # -- per-layer MeZO scorer (EcoFLaP-style) -------------------------
    @torch.no_grad()
    def _score_mezo_layer(self, keys) -> Dict[Path, float]:
        one = self.score_compute.startswith("olmezo")
        num_samples = self.num_data if one else min(self.num_data, 8)

        def z_fn(tag, k, shape):
            return (self._injected(tag, k, shape) if self.noise_fn is not None
                    else self._z(shape, (1, *tag)))

        grad_scalar = mezo_layer_scalars(
            self.model, keys, self._batches(num_samples), self.loss_fn,
            eps=self.noise_eps, num_noise=self.num_noise if one else 4,
            num_samples=num_samples, z_fn=z_fn, abs_each=one)

        sums = {}
        for k in keys:
            g = grad_scalar[k]
            w = self._kernel(k).float()
            if self.score_compute.endswith("obd") and not \
                    self.score_compute.endswith("aobd"):
                sums[k] = float(torch.sum(w * w)) * g * g
            elif self.score_compute.endswith("aobd"):
                sums[k] = float(torch.sum(torch.abs(w))) * g
            else:
                # *mezo-gradient: the group score is the bare |projected
                # grad| scalar, not scaled by numel
                sums[k] = g
        return sums
