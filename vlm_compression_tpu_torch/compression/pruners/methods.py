"""Per-block mask functions (port of the Wanda (with RIA and hybrid tiles),
SparseGPT, DSnoT, soft-mask and GPTQ (with AWQ) parts of
``vlm_compression_tpu/compression/pruners/methods.py``).  Kernels arrive
(in, out); scoring runs unit-major (out, in) and keep-masks go back
(in, out), contiguous for the masked-matmul kernel.

The JAX functions also return a per-linear importance
(``BlockPruneResult.importances``).  Nothing in either package reads it
(the engine applies masks and kernels only, and no CLI saves it), so the
port does not compute it; the soft-mask fn can hand its OBS errors to a
caller's list instead."""

from __future__ import annotations

import torch

from vlm_compression_tpu_torch.compression.calibrate import BlockPruneResult
from vlm_compression_tpu_torch.ops.awq import (
    apply_awq,
    awq_search,
    unscale_weight,
)
from vlm_compression_tpu_torch.ops.dsnot import dsnot_refine_mask
from vlm_compression_tpu_torch.ops.gptq import (
    gptq_quantize_batched,
    gptq_quantize_group,
)
from vlm_compression_tpu_torch.ops.sparsegpt import sparsegpt_prune_group
from vlm_compression_tpu_torch.ops.masks import (
    flat_threshold_mask,
    hybrid_tile_mask,
    nm_structured_mask,
    ria_metric,
    unstructured_mask,
    wanda_metric,
)
from vlm_compression_tpu_torch.ops.softmask import softmask_nm_prune_batched
from vlm_compression_tpu_torch.ops.stats import finalize_hessian


def wanda_mask_fn(prune_n: int = 0, prune_m: int = 0,
                  flat_threshold: bool = False, metric: str = "wanda",
                  ria_alpha: float = 0.5, hybrid_tile: int = 0):
    """Wanda |W|·sqrt(E‖X‖²).  flat_threshold=True selects the per-tensor
    value threshold used for the ViT; False the per-unit top-k of the
    language towers; prune_n > 0 selects n:m.  metric="ria" swaps in the
    RIA importance (same statistics, same sweep); hybrid_tile > 0 with n:m
    keeps the most salient tiles dense and the rest n:m, at the linear's
    target sparsity overall."""

    def one(kernel, scaler_row, sparsity):
        if metric == "ria":
            met = ria_metric(kernel.T, scaler_row, alpha=ria_alpha)
        else:
            met = wanda_metric(kernel.T, scaler_row)
        if prune_n > 0 and hybrid_tile > 0:
            keep = hybrid_tile_mask(met, sparsity, prune_n, prune_m,
                                    tile=hybrid_tile)
        elif prune_n > 0:
            keep = nm_structured_mask(met, prune_n, prune_m)
        elif flat_threshold:
            keep = flat_threshold_mask(met, sparsity)
        else:
            keep = unstructured_mask(met, sparsity)
        return keep.T.contiguous()

    def fn(kernels, stats, sparsities):
        return BlockPruneResult(
            {p: one(k, stats[p].scaler_row, float(sparsities[p]))
             for p, k in kernels.items()}, {})

    # the per-unit top-k and n:m split on units over a model group as they
    # stand; the flat threshold, RIA's sums and the hybrid tiles need the
    # whole kernel
    fn.unit_split = (metric == "wanda" and not flat_threshold
                     and not (prune_n > 0 and hybrid_tile > 0))
    return fn


def sparsegpt_mask_fn(prune_n: int = 0, prune_m: int = 0,
                      blocksize: int = 128, percdamp: float = 0.01):
    """OBS prune-with-update; always returns updated kernels (the
    reference assigns weight.data unconditionally).  Linears of one
    (shape, sparsity) are solved as one batched group (T5's q/k/v/o)."""

    def fn(kernels, stats, sparsities, unit_group=None):
        groups = {}
        for p, k in kernels.items():
            groups.setdefault((tuple(k.shape), float(sparsities[p])),
                              []).append(p)
        masks, new_k = {}, {}
        for (_, sp), paths in groups.items():
            out = sparsegpt_prune_group(
                [kernels[p] for p in paths], [stats[p] for p in paths], sp,
                prune_n=prune_n, prune_m=prune_m, blocksize=blocksize,
                percdamp=percdamp, unit_group=unit_group)
            for (keep, w, _), p in zip(out, paths):
                masks[p] = keep
                new_k[p] = w
        return BlockPruneResult(masks, new_k)

    fn.unit_split = True
    fn.takes_unit_group = True
    return fn


def dsnot_mask_fn(prune_n: int = 0, prune_m: int = 0,
                  initial_method: str = "wanda",
                  max_cycle_time: int = 50,
                  update_threshold: float = 0.1,
                  pow_of_var_regrowing: float = 1.0,
                  without_same_sign: bool = True,
                  without_dsnot: bool = False):
    """DSnoT refinement of each linear, one at a time (each loop ends
    where its own rows stop).  ``initial_method="sparsegpt"`` reads the
    block's finalized Hessians.  The JAX function also returns each
    linear's mean |Wanda metric|; nothing in the port reads it, so it is
    not computed."""

    def fn(kernels, stats, sparsities):
        masks = {}
        for p, k in kernels.items():
            s = stats[p]
            h = (finalize_hessian(s) if (initial_method == "sparsegpt"
                                         and s.hessian is not None) else None)
            res = dsnot_refine_mask(
                k.T, s.scaler_row, s.sum_metric_row, s.var,
                float(sparsities[p]), prune_n=prune_n, prune_m=prune_m,
                max_cycle_time=max_cycle_time,
                update_threshold=update_threshold,
                pow_of_var_regrowing=pow_of_var_regrowing,
                without_same_sign=without_same_sign,
                without_dsnot=without_dsnot,
                initial_method=initial_method, hessian=h)
            masks[p] = res.keep_mask.T.contiguous()
        return BlockPruneResult(masks, {})

    return fn


def softmask_mask_fn(prune_n: int = 0, prune_m: int = 0,
                     steps: int = 48, lr: float = 0.1,
                     tau_start: float = 2.0, tau_end: float = 0.05,
                     errors: list = None):
    """Annealed Hessian-guided soft-mask n:m (``ops/softmask.py``): logits
    start from the Wanda metric, the objective is the calibration
    Hessians' OBS error, and the start mask is kept unless the anneal
    finds a better one.  n:m only.  Equal-shape linears of a block anneal
    together as one batched call.  ``errors``: a list that receives
    (err_best, err_init) of each linear, as device scalars."""
    if prune_n <= 0 or prune_m <= 0:
        raise ValueError("softmask pruning is n:m only — set "
                         "--prune_n/--prune_m (e.g. 2:4)")

    def fn(kernels, stats, sparsities, unit_group=None):
        groups = {}
        for p, k in kernels.items():
            groups.setdefault(tuple(k.shape), []).append(p)
        masks = {}
        for paths in groups.values():
            keep, err_t, err_i = softmask_nm_prune_batched(
                torch.stack([kernels[p].T for p in paths]),
                torch.stack([finalize_hessian(stats[p]) for p in paths]),
                prune_n, prune_m,
                init_metrics=torch.stack([
                    wanda_metric(kernels[p].T, stats[p].scaler_row)
                    for p in paths]),
                steps=steps, lr=lr, tau_start=tau_start, tau_end=tau_end)
            for i, p in enumerate(paths):
                masks[p] = keep[i].T.contiguous()
                if errors is not None:
                    errors.append((err_t[i], err_i[i]))
        return BlockPruneResult(masks, {})

    return fn


def gptq_fn(prune_n: int = 0, prune_m: int = 0, bits: int = 4,
            groupsize: int = 128, sym: bool = True, act_order: bool = False,
            blocksize: int = 128, percdamp: float = 0.01,
            awq: bool = False):
    """GPTQ as a calibration-engine method (``ops/gptq.py``): sparsity 0
    quantizes only (all-True keep masks); sparsity > 0 or n:m prunes and
    quantizes in one OBS sweep, on the Hessians the sweep accumulates.
    Linears of one (shape, sparsity) are swept as one batched group.  With
    ``awq``: the AWQ scale search on the same statistics, GPTQ of the
    scaled problem, the fake-quant weights unscaled back."""

    def fn(kernels, stats, sparsities, unit_group=None):
        groups = {}
        for p, k in kernels.items():
            groups.setdefault((tuple(k.shape), float(sparsities[p])),
                              []).append(p)
        masks, new_k = {}, {}
        for (_, sp), paths in groups.items():
            kw = dict(bits=bits, groupsize=groupsize, sym=sym,
                      act_order=act_order, sparsity=sp, prune_n=prune_n,
                      prune_m=prune_m, blocksize=blocksize,
                      percdamp=percdamp)
            if not awq:
                out = gptq_quantize_group(
                    [kernels[p] for p in paths], [stats[p] for p in paths],
                    **kw)
                for (keep, w, _), p in zip(out, paths):
                    masks[p] = keep
                    new_k[p] = w
                continue
            ws, hs, ss = [], [], []
            for p in paths:
                h = finalize_hessian(stats[p])
                sc = awq_search(kernels[p].T, stats[p].scaler_row, h,
                                bits=bits, groupsize=groupsize, sym=sym)
                w, h = apply_awq(kernels[p].T, h, sc.s)
                ws.append(w)
                hs.append(h)
                ss.append(sc.s)
            res = gptq_quantize_batched(torch.stack(ws), torch.stack(hs),
                                        **kw)
            del ws, hs
            for i, p in enumerate(paths):
                masks[p] = res.keep_mask[i].T.contiguous()
                new_k[p] = unscale_weight(res.weight[i], ss[i]).to(
                    kernels[p].dtype).T.contiguous()
        return BlockPruneResult(masks, new_k)

    return fn
