"""Layerwise calibration engine (port of
``vlm_compression_tpu/compression/calibrate.py``).

Each tower exposes a *stem* (everything before block 0, run once over the
calibration set) and addressable blocks.  Per block the engine

  1. folds calibration statistics of every SparseLinear's input over the
     (fused) calibration batch — a forward pre-hook on each linear folds
     its input as the block runs, so no activation is kept;
  2. scores and masks every linear of the block (the mask fn);
  3. replays the batch through the *pruned* block in ``masked`` mode to
     produce the next block's input.

Masks and zeroed kernels are written into the modules in place, so no
superseded copy of a block is ever held (the JAX package popped each old
block subtree for the same reason).  Sparsity keys are '/'-joined
parameter paths (``t5_model/encoder/blocks_3/self_attn/q``).

Over a mesh (``parallel/mesh.shard_params``; the model's
``parallel_mesh``) the sweep is distributed: each data rank folds its
share of the batches, and the statistics' sums are all-reduced over
(``replica``, ``data``) before any mask is taken; a row-parallel linear
folds its local input features and gathers the per-feature sums over
``model`` (its inputs gathered instead where a Hessian needs their cross
terms).  The mask function sees whole kernels; where it splits on
units (``unit_split``: Wanda's per-unit top-k, SparseGPT's row-parallel
OBS) each ``model`` rank scores its block of the units and the masks (and
updated kernels) are all-gathered, else every rank scores the whole.  The
masks are written whole on every rank (so ``export_masks`` and checkpoints
do not change), updated or zeroed kernels into each rank's stored block,
and the replay runs the sharded forward, reduced as the towers reduce it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from vlm_compression_tpu_torch.models.layers import (
    SparseLinear,
    assign_whole_,
    set_mask,
    whole,
)
from vlm_compression_tpu_torch.ops.stats import (
    CalibStats,
    all_reduce_calib_stats,
    init_calib_stats,
    update_calib_stats,
)
from vlm_compression_tpu_torch.parallel import collectives as C
from vlm_compression_tpu_torch.parallel.mesh import (
    axis_group,
    data_axes,
)

Path = Tuple[str, ...]


def linear_paths(block: torch.nn.Module) -> List[Path]:
    """Every SparseLinear in a block, as sorted name paths."""
    return sorted(tuple(name.split(".")) for name, m in block.named_modules()
                  if isinstance(m, SparseLinear))


@dataclasses.dataclass
class TowerAdapter:
    """Binds a tower's blocks to the engine.

    block_fn(block, x, side, mode) -> out
    stem_fn(batch) -> (x0, side); side holds what every block needs
      (attention biases, encoder outputs).
    blocks: the module whose ``block_names`` children are the blocks;
    subtree: its path in the model (for the sparsity keys).
    """

    name: str
    blocks: torch.nn.Module
    block_names: List[str]
    block_fn: Callable
    stem_fn: Callable
    subtree: Tuple[str, ...] = ()


@dataclasses.dataclass
class BlockPruneResult:
    masks: Dict[Path, torch.Tensor]        # keep-masks (in, out)
    new_kernels: Dict[Path, torch.Tensor]  # updated weights, or {}


def fuse_batch_dicts(batches: Sequence[dict]) -> Sequence[dict]:
    """Concatenate equal-schema batch dicts into one: tensors of equal
    shape concatenate on axis 0, anything else keeps the first batch's
    value.  Returns the input unchanged when fusion does not apply."""
    if len(batches) <= 1:
        return batches
    first = batches[0]
    if any(set(b.keys()) != set(first.keys()) for b in batches):
        return batches
    out = {}
    for k, v in first.items():
        vals = [b[k] for b in batches]
        if (getattr(v, "ndim", 0) > 0
                and all(getattr(y, "shape", None) == v.shape for y in vals)):
            out[k] = torch.cat([torch.as_tensor(y) for y in vals], dim=0)
        else:
            out[k] = v
    return [out]


def with_outputs(batches: Sequence[dict], outs: Sequence[torch.Tensor],
                 key: str) -> List[dict]:
    """Each calibration batch dict with a tower's replayed activations under
    ``key``, for the next tower's stem.  The engine fuses stems of one
    shape into one batch: then one output covers every batch.  When every
    array of the batch dicts has one shape across them, one fused dict
    takes it; else (prompts of several lengths at batch 1) the output is
    split back along the batch axis, a slice to each batch."""
    if len(outs) == len(batches):
        return [dict(b, **{key: x}) for b, x in zip(batches, outs)]
    first = batches[0]
    if all(set(b) == set(first) for b in batches) and all(
            getattr(first[k], "ndim", 0) == 0 or all(
                getattr(b[k], "shape", None) == first[k].shape
                for b in batches) for k in first):
        return [dict(fuse_batch_dicts(batches)[0], **{key: outs[0]})]
    sizes = [next(v.shape[0] for v in b.values()
                  if getattr(v, "ndim", 0) > 0) for b in batches]
    return [dict(b, **{key: x})
            for b, x in zip(batches, torch.split(outs[0], sizes))]


def _fuse_side(sides: List[dict], batch_sizes: List[int]) -> dict:
    """Concatenate per-batch side tensors whose leading dim is the batch."""
    out = {}
    for key, v in sides[0].items():
        vals = [s[key] for s in sides]
        if (isinstance(v, torch.Tensor) and v.ndim > 0
                and all(t.shape == v.shape for t in vals)
                and v.shape[0] == batch_sizes[0]):
            out[key] = torch.cat(vals, dim=0)
        else:
            out[key] = v
    return out


def _whole_features(stats: CalibStats, lin: SparseLinear) -> CalibStats:
    """A row-parallel linear's statistics of its local input features,
    all-gathered to every feature (the plan's rows are the rank's
    contiguous block); the counts are the same on every rank.  Statistics
    of whole inputs pass."""
    if stats.ssq.numel() == lin.in_features:
        return stats
    return dataclasses.replace(stats, **{
        f: C.all_gather_dim(getattr(stats, f), lin.tp.group, 0)
        for f in ("ssq", "ssum", "var_acc", "mean_acc")})


def _score(mask_fn, kernels, stats, sparsities, mp) -> BlockPruneResult:
    """``mask_fn`` over whole kernels; split on the units over ``mp`` where
    the function allows it and every kernel's units divide, then the masks
    and kernels all-gathered whole."""
    n = C.group_size(mp)
    if n == 1 or not getattr(mask_fn, "unit_split", False) or any(
            k.shape[1] % n for k in kernels.values()):
        return mask_fn(kernels=kernels, stats=stats, sparsities=sparsities)
    local = {p: C.chunk(k, mp, 1).contiguous() for p, k in kernels.items()}
    kw = {"unit_group": mp} if getattr(mask_fn, "takes_unit_group",
                                       False) else {}
    res = mask_fn(kernels=local, stats=stats, sparsities=sparsities, **kw)
    return BlockPruneResult(
        {p: C.all_gather_dim(m.contiguous(), mp, 1)
         for p, m in res.masks.items()},
        {p: C.all_gather_dim(k.contiguous(), mp, 1)
         for p, k in res.new_kernels.items()})


@torch.no_grad()
def calibrate_and_prune_tower(
    adapter: TowerAdapter,
    batches: Sequence[dict],
    mask_fn: Callable[..., BlockPruneResult],
    sparsity_for: Callable[[str], float],
    with_hessian: bool = False,
    lora_model: bool = True,
    mode: str = "masked",
    progress: Optional[Callable[[str], None]] = None,
    return_outputs: bool = False,
    mesh=None,
    stats_sink: Optional[dict] = None,
):
    """Run the layer sweep over one tower, in place.

    lora_model=True writes each linear's keep-mask; lora_model=False
    instead zeroes the pruned weights and drops the swept linears' masks
    (zeroed weights already encode the sparsity).  With
    ``return_outputs`` the replayed activations after the last block come
    back, per (fused) batch.  ``mesh``: the sweep over a mesh (the module
    docstring).  ``stats_sink`` (a test and debug hook, as the JAX
    package's): each linear's Wanda input statistic, ``scaler_row`` on the
    host, and its sparsity, under its sparsity key, so that a comparison
    can evaluate the metric where two masks differ."""
    dp = axis_group(mesh, data_axes(mesh)) if mesh is not None else None
    mp = axis_group(mesh, "model") if mesh is not None else None
    # 1. stem over every batch, then FUSE equal shapes into one batch:
    # statistics are sums over samples and tokens, so concatenation is
    # exact, and one fold + one replay per block replaces len(batches)
    xs, sides = [], []
    for b in batches:
        x0, side = adapter.stem_fn(b)
        xs.append(x0)
        sides.append(side)
    if len(xs) > 1 and all(x.shape == xs[0].shape for x in xs) and all(
            set(s) == set(sides[0]) for s in sides):
        sides = [_fuse_side(sides, [x.shape[0] for x in xs])]
        xs = [torch.cat(xs, dim=0)]

    for bi, bname in enumerate(adapter.block_names):
        block = getattr(adapter.blocks, bname)
        lpaths = linear_paths(block)
        linears = {p: block.get_submodule(".".join(p)) for p in lpaths}

        # 2a. fold stats: each linear's input, as the block runs (a
        # row-parallel linear's local features folded as they come, and
        # the per-feature sums gathered after; with a Hessian, which needs
        # the cross terms, its input gathered first)
        stats: Dict[Path, CalibStats] = {}

        def hook_for(p):
            lin = linears[p]

            def hook(_mod, args):
                x = args[0]
                if with_hessian and x.shape[-1] != lin.in_features:
                    x = C.all_gather_dim(x, lin.tp.group, -1)
                if p not in stats:
                    stats[p] = init_calib_stats(x.shape[-1], with_hessian,
                                                lin.kernel.device)
                stats[p] = update_calib_stats(stats[p], x)
            return hook

        handles = [lin.register_forward_pre_hook(hook_for(p))
                   for p, lin in linears.items()]
        try:
            for x, side in zip(xs, sides):
                adapter.block_fn(block, x, side, mode)
        finally:
            for h in handles:
                h.remove()

        # 2b. score + mask (+ update), on whole kernels and statistics
        stats = {p: all_reduce_calib_stats(
            _whole_features(stats[p], lin) if p in stats else
            init_calib_stats(lin.in_features, with_hessian,
                             lin.kernel.device), dp)
            for p, lin in linears.items()}
        kernels = {p: whole(lin, "kernel") for p, lin in linears.items()}
        sparsities = {p: sparsity_for("/".join(adapter.subtree + (bname,) + p))
                      for p in lpaths}
        if stats_sink is not None:
            for p in lpaths:
                stats_sink["/".join(adapter.subtree + (bname,) + p)] = (
                    stats[p].scaler_row.cpu(), float(sparsities[p]))
        result = _score(mask_fn, kernels, stats, sparsities, mp)
        del stats
        for p, lin in linears.items():
            keep = result.masks[p]
            if lora_model:
                set_mask(lin, keep)
            kern = result.new_kernels.get(p)
            if kern is not None:
                assign_whole_(lin, "kernel", kern.to(lin.kernel.dtype))
            elif not lora_model:
                sh = getattr(lin, "_shards", {}).get("kernel")
                lin.kernel.masked_fill_(~(sh.local_of(keep) if sh else keep),
                                        0)

        # 3. replay through the pruned block; without LoRA the zeroed
        # weights stand alone: the block's masks leave the model after the
        # replay, as they leave the JAX package's variable tree
        xs = [adapter.block_fn(block, x, side, mode)
              for x, side in zip(xs, sides)]
        if not lora_model:
            for lin in linears.values():
                set_mask(lin, None)
        if progress:
            dens = torch.stack([result.masks[p].float().mean()
                                for p in lpaths]).mean()
            progress(f"[{adapter.name}] block {bi + 1}/"
                     f"{len(adapter.block_names)} density={float(dens):.3f}")
    return xs if return_outputs else None
