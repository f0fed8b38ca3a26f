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
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from vlm_compression_tpu_torch.models.layers import SparseLinear, set_mask
from vlm_compression_tpu_torch.ops.stats import (
    CalibStats,
    init_calib_stats,
    update_calib_stats,
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
):
    """Run the layer sweep over one tower, in place.

    lora_model=True writes each linear's keep-mask; lora_model=False
    instead zeroes the pruned weights and drops the swept linears' masks
    (zeroed weights already encode the sparsity).  With
    ``return_outputs`` the replayed activations after the last block come
    back, per (fused) batch."""
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

        # 2a. fold stats: each linear's input, as the block runs
        stats: Dict[Path, CalibStats] = {
            p: init_calib_stats(lin.in_features, with_hessian,
                                lin.kernel.device)
            for p, lin in linears.items()}

        def hook_for(p):
            def hook(_mod, args):
                stats[p] = update_calib_stats(stats[p], args[0])
            return hook

        handles = [lin.register_forward_pre_hook(hook_for(p))
                   for p, lin in linears.items()]
        try:
            for x, side in zip(xs, sides):
                adapter.block_fn(block, x, side, mode)
        finally:
            for h in handles:
                h.remove()

        # 2b. score + mask (+ update)
        kernels = {p: lin.kernel for p, lin in linears.items()}
        sparsities = {p: sparsity_for("/".join(adapter.subtree + (bname,) + p))
                      for p in lpaths}
        result = mask_fn(kernels=kernels, stats=stats, sparsities=sparsities)
        del stats
        for p, lin in linears.items():
            keep = result.masks[p]
            if lora_model:
                set_mask(lin, keep)
            kern = result.new_kernels.get(p)
            if kern is not None:
                lin.kernel.copy_(kern.to(lin.kernel.dtype))
            elif not lora_model:
                lin.kernel.masked_fill_(~keep, 0)

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
