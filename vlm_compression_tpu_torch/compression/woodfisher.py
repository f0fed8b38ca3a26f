"""WoodFisher importance: a blockwise empirical Fisher inverse (port of
``vlm_compression_tpu/compression/woodfisher.py``).

  * the empirical Fisher F = damp·I + (1/N) Σₙ gₙgₙᵀ over per-sample
    gradients, in independent diagonal blocks ("parts") of each parameter;
  * F⁻¹ kept directly through the Sherman–Morrison recursion
      F⁻¹ ← F⁻¹ − (F⁻¹gₙ)(F⁻¹gₙ)ᵀ / (N + gₙᵀF⁻¹gₙ),
    seeded with F⁻¹ = I/damp, one sample at a time, as batched float32
    products over the blocks;
  * the OBD importance w² / (2·diag(F⁻¹)) per weight.

Each leaf is flattened and split into ``fisher_parts`` chunks of at most
``max_chunk`` entries; the estimate is exact within a chunk, so which
weights share a chunk decides the scores.  Paths are the JAX package's key
tuples (``("visual_encoder", "blocks_0", "attn", "qkv", "kernel")``), and
the port keeps Flax's (in, out) kernel layout, so a gradient flattened as
it stands is in JAX's order and its chunks hold the same weights as JAX's.

Per-sample gradients come from autograd over every floating parameter, one
sample at a time, with ``compression/derivatives.py``'s loss; T5's
relative-position embeddings take part, so on the card each sample runs
the attention backward with its bias-gradient output.  The block inverses
take numel × chunk × 4 bytes: a whole XL tower does not fit on one card,
so ``include`` names the leaves to score.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from vlm_compression_tpu_torch.compression.derivatives import _default_loss

Path = Tuple[str, ...]

# chunks of a leaf folded at once (bounds the rank-1 update's transient)
_FOLD_PARTS = 4096


@torch.no_grad()
def _sm_fold(finv: torch.Tensor, grads: torch.Tensor, num_samples: int
             ) -> torch.Tensor:
    """Fold per-sample chunked gradients into block Fisher inverses, in
    place.

    finv  : (P, C, C) running block inverses, float32.
    grads : (n, P, C) per-sample gradients for this leaf, chunked.
    """
    for g in grads.float():
        for s in range(0, finv.shape[0], _FOLD_PARTS):
            f, gs = finv[s:s + _FOLD_PARTS], g[s:s + _FOLD_PARTS]
            v = torch.bmm(f, gs[:, :, None])[:, :, 0]
            denom = num_samples + (gs * v).sum(dim=-1)
            f.sub_(v[:, :, None] * v[:, None, :] / denom[:, None, None])
    return finv


def _chunk(flat: torch.Tensor, chunk: int) -> torch.Tensor:
    """(n, numel) → (n, P, C), zero-padded to a whole number of chunks."""
    n, numel = flat.shape
    parts = -(-numel // chunk)
    pad = parts * chunk - numel
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(n, parts, chunk)


class WoodFisher:
    """Blockwise Fisher-inverse importance scorer.

    model      : the port's model (an ``nn.Module``).
    batches    : calibration batches (dicts of tensors on the model's
                 device, leading batch dim).
    num_samples: the N of the Fisher average; that many samples are used.
    include    : optional predicate on a parameter's path tuple; leaves
                 that fail it are skipped.
    ignore_keys: substrings of the '/'-joined path that skip a leaf.
    """

    def __init__(self, model: torch.nn.Module, batches: Sequence,
                 num_samples: int, fisher_damp: float = 1e-3,
                 fisher_parts: int = 5, ignore_keys: Sequence[str] = (),
                 include: Optional[Callable[[Path], bool]] = None,
                 max_chunk: int = 256):
        self.model = model
        self.batches = batches
        self.num_samples = int(num_samples)
        self.fisher_damp = float(fisher_damp)
        self.fisher_parts = int(fisher_parts)
        self.ignore_keys = tuple(ignore_keys)
        self.include = include
        self.max_chunk = int(max_chunk)

    def _keep(self, path: Path) -> bool:
        name = "/".join(path)
        if any(k in name for k in self.ignore_keys):
            return False
        return self.include(path) if self.include else True

    def _chunk_size(self, numel: int) -> int:
        return max(1, min(self.max_chunk, -(-numel // self.fisher_parts)))

    def _per_sample_grads(self):
        """Yield {path: gradient} of the kept leaves, one per sample.
        Every floating parameter is differentiated whatever its
        ``requires_grad``; the flags are restored afterwards."""
        named = [(tuple(n.split(".")), p)
                 for n, p in self.model.named_parameters()
                 if p.is_floating_point()]
        params = [p for _, p in named]
        flags = [(p, p.requires_grad) for p in params]
        seen = 0
        try:
            for p in params:
                p.requires_grad_(True)
            for batch in self.batches:
                bs = next(iter(batch.values())).shape[0]
                for i in range(bs):
                    if seen >= self.num_samples:
                        return
                    sample = {k: v[i:i + 1] for k, v in batch.items()}
                    with torch.enable_grad():
                        grads = torch.autograd.grad(
                            _default_loss(self.model, sample), params,
                            allow_unused=True)
                    yield {path: (torch.zeros_like(p) if g is None else g)
                           for (path, p), g in zip(named, grads)
                           if self._keep(path)}
                    del grads
                    seen += 1
        finally:
            for p, flag in flags:
                p.requires_grad_(flag)

    def compute_fisher_inv_and_importance_score(self) -> Dict[Path,
                                                              torch.Tensor]:
        """{path: importance (the parameter's shape), float32}; the block
        inverses' diagonals are kept in ``self.fisher_inv_diag``."""
        finv: Dict[Path, torch.Tensor] = {}
        shapes: Dict[Path, torch.Size] = {}
        for g in self._per_sample_grads():
            for path, leaf in g.items():
                c = self._chunk_size(leaf.numel())
                chunked = _chunk(leaf.float().reshape(1, -1), c)
                if path not in finv:
                    shapes[path] = leaf.shape
                    eye = torch.eye(c, dtype=torch.float32,
                                    device=leaf.device) / self.fisher_damp
                    finv[path] = eye.expand(chunked.shape[1], c, c).clone()
                _sm_fold(finv[path], chunked, self.num_samples)
            del g

        params = dict(self.model.named_parameters())
        self.fisher_inv_diag = {}
        scores: Dict[Path, torch.Tensor] = {}
        for path in list(finv):
            shape = shapes[path]
            numel = shape.numel()
            diag = torch.diagonal(finv.pop(path), dim1=1,
                                  dim2=2).reshape(-1)[:numel].clone()
            self.fisher_inv_diag[path] = diag.reshape(shape)
            w = params[".".join(path)].detach().float().reshape(-1)
            scores[path] = ((w * w) / (2.0 * diag.clamp_min(1e-20))
                            ).reshape(shape)
        return scores
