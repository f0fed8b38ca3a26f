"""Bit-packed keep-masks (port of ``vlm_compression_tpu/ops/bitmask.py``).

A bool keep-mask costs one byte per weight at rest and, in the masked
forward, half as many bytes again as the bf16 weight stream.  Packed, a
mask costs 2 bits per weight (GROUP = 128, 4× smaller) or 1 bit
(GROUP = 256, 8× smaller).

Layout, as in the JAX package, so that a mask packed by either package
loads in the other: a kernel ``(in, out)`` packs along the contraction
axis (rows), one GROUP-row group at a time; mask row ``G·g + r`` lives in
word row ``8g + (r % 8)`` at bit ``r // 8``.  Every group packs into 8
word rows; GROUP = 128 uses bits 0..15 of each word, GROUP = 256 all 32.
Rows pad up to a multiple of GROUP.

torch has no 32-bit unsigned arithmetic on every op, so the words are
``torch.int32`` holding the JAX package's uint32 bit patterns (bit 31 is
the sign bit; it is read with shifts and masks only, never compared).
The bridge converts either way bit for bit, and the kernels
(``csrc/masked_matmul.cu``, ``csrc/int8_matmul.cu``) read the raw words.
"""

from __future__ import annotations

import torch
from torch import nn

GROUP = 128        # default mask rows per packed group (2 bits a weight)
GROUP_1BIT = 256   # full-word layout: 1 bit a weight
WPG = 8            # word rows per group

_TWO_32 = 1 << 32


def packed_rows(n_rows: int, group: int = GROUP) -> int:
    return WPG * ((n_rows + group - 1) // group)


def pack_mask(mask: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """(in, out) bool → (8·⌈in/group⌉, out) int32 words, interleaved:
    mask row group·g + r ↔ word row 8g + r % 8, bit r // 8."""
    bits = group // WPG
    if group % WPG or bits > 32:
        raise ValueError(f"pack group {group}: a multiple of 8, at most 256")
    n, m = mask.shape
    pad = (-n) % group
    b = torch.nn.functional.pad(mask.to(torch.int64), (0, 0, 0, pad))
    g = b.shape[0] // group
    # row r = bit·WPG + word → (g, bits, WPG, m): axis 1 bit, axis 2 word
    shifts = torch.arange(bits, dtype=torch.int64,
                          device=mask.device)[None, :, None, None]
    words = (b.reshape(g, bits, WPG, m) << shifts).sum(dim=1)
    words = torch.where(words >= 1 << 31, words - _TWO_32, words)
    return words.reshape(g * WPG, m).to(torch.int32)


def unpack_mask(packed: torch.Tensor, n_rows: int,
                group: int = GROUP) -> torch.Tensor:
    """(8·⌈n/group⌉, out) words → (n_rows, out) bool.  An arithmetic shift
    of an int32 word keeps bit ``s`` as its lowest bit, so ``& 1`` reads
    bit 31 as well as the others."""
    bits = group // WPG
    p, m = packed.shape
    g = p // WPG
    words = packed.to(torch.int32).reshape(g, 1, WPG, m)
    shifts = torch.arange(bits, dtype=torch.int32,
                          device=packed.device)[None, :, None, None]
    vals = (words >> shifts) & 1
    return vals.reshape(g * group, m)[:n_rows].bool()


def is_packed(mask) -> bool:
    """Packed masks are 32-bit words; bool masks are the unpacked form."""
    return mask is not None and mask.dtype in (torch.int32, torch.uint32)


def infer_pack_group(k_rows: int, n_packed_rows: int) -> int:
    """The pack layout (128 = 2-bit, 256 = 1-bit) from the shapes.  At
    k_rows ≤ 128 the two layouts are the same words."""
    for g in (GROUP, GROUP_1BIT):
        if packed_rows(k_rows, g) == n_packed_rows:
            return g
    raise ValueError(f"packed mask rows {n_packed_rows} do not match any "
                     f"layout for {k_rows} weight rows")


def pack_masks_tree(masks: dict, group: int = GROUP) -> dict:
    """Pack every {'mask': bool (in, out)} leaf of a nested masks dict,
    recording ``mask_rows`` (the unpadded row count) and ``mask_group``."""
    if isinstance(masks, dict):
        m = masks.get("mask")
        if isinstance(m, torch.Tensor) and m.ndim == 2 \
                and m.dtype == torch.bool:
            return {"mask": pack_mask(m, group), "mask_rows": m.shape[0],
                    "mask_group": group}
        return {k: pack_masks_tree(v, group) for k, v in masks.items()}
    return masks


def unpack_masks_tree(masks: dict) -> dict:
    """Inverse of ``pack_masks_tree``."""
    if isinstance(masks, dict):
        m = masks.get("mask")
        if isinstance(m, torch.Tensor) and is_packed(m):
            return {"mask": unpack_mask(m, int(masks["mask_rows"]),
                                        int(masks.get("mask_group", GROUP)))}
        return {k: unpack_masks_tree(v) for k, v in masks.items()}
    return masks


@torch.no_grad()
def pack_masks_(model: nn.Module, group: int = GROUP) -> nn.Module:
    """Pack the keep-mask of every SparseLinear of ``model`` in place (a
    packed mask is repacked at ``group``): the port of ``train.py
    --pack_masks``.  The group is read back from the words' shape
    (``infer_pack_group``)."""
    from vlm_compression_tpu_torch.models.layers import SparseLinear, set_mask

    for m in model.modules():
        if isinstance(m, SparseLinear) and m.mask is not None:
            set_mask(m, pack_mask(m.bool_mask(), group))
    return model
