"""GradCAM maps (port of ``vlm_compression_tpu/common/gradcam.py``):
relevance = ReLU(∂loss/∂attn) ⊙ attn, averaged over heads, the CLS query's
row over the patch keys laid onto the patch grid and scaled to [0, 1]; and
``getAttMap``, the map blended onto an image.

``compute_gradcam_map`` is numpy.  ``getAttMap`` resizes and blurs with
Pillow, imported where it is called (no task and no card path reaches it;
the card's machine has no Pillow).
"""

from __future__ import annotations

import numpy as np


def compute_gradcam_map(attn: np.ndarray, grad: np.ndarray,
                        patch_hw: int) -> np.ndarray:
    """(heads, q, k) attention and its gradient → (patch_hw, patch_hw)
    relevance over the image patches (the CLS query's row, the patch key
    columns), min-max scaled."""
    rel = np.maximum(grad, 0) * attn
    rel = rel.mean(axis=0)               # average over heads → (q, k)
    cam = rel[0, 1: 1 + patch_hw * patch_hw].reshape(patch_hw, patch_hw)
    lo, hi = cam.min(), cam.max()
    return (cam - lo) / (hi - lo + 1e-8)


def getAttMap(img: np.ndarray, att_map: np.ndarray,
              blur: bool = True, overlap: bool = True) -> np.ndarray:
    """A normalized attention map blended onto an HWC float image (the
    reference's ``getAttMap`` signature)."""
    from PIL import Image, ImageFilter

    h, w = img.shape[:2]
    amap = np.asarray(
        Image.fromarray((att_map * 255).astype(np.uint8)).resize(
            (w, h), Image.BICUBIC), np.float32) / 255.0
    if blur:
        amap = np.asarray(
            Image.fromarray((amap * 255).astype(np.uint8)).filter(
                ImageFilter.GaussianBlur(radius=0.02 * max(h, w))),
            np.float32) / 255.0
    heat = np.stack([amap, np.zeros_like(amap), 1.0 - amap], axis=-1)
    if overlap:
        return (1 - amap[..., None]) * img + amap[..., None] * heat
    return heat
