"""Pillow's bicubic resize of 8-bit RGB images, in numpy.

The card's machine has no Pillow, and the image processors resize there;
this is a copy of ``libImaging/Resample.c``'s ``ImagingResample`` for
8-bit channels and the BICUBIC filter (a = −0.5, support 2), bit for bit:
the horizontal pass over the rows the vertical pass needs, then the
vertical pass, each with

* the filter's support widened by the scale when downscaling;
* per output pixel the input window ``[xmin, xmin + xmax)`` around the
  centre ``box0 + (x + 0.5)·scale``, its weights normalised to sum 1 and
  turned into fixed point with 22 fractional bits (rounded half away from
  zero);
* a rounding bias of 2^21, an arithmetic shift by 22 and a clip to 0..255
  after each pass (the intermediate image is 8-bit too).

``box`` is Pillow's crop box in float32 (left, upper, right, lower) of
the source, as ``Image.resize(size, BICUBIC, box)`` takes it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

_PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(
        x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
        np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, in0: float, in1: float, out_size: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xmin (out,), xmax (out,), fixed-point weights (out, ksize))."""
    scale = float(np.float32(in1) - np.float32(in0)) / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = float(np.float32(in0)) + (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; both bounds are clipped after
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    w = _bicubic((x[None, :] + xmin[:, None] - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(x[None, :] < xmax[:, None], w, 0.0)
    ww = w.sum(axis=1, keepdims=True)
    # the C loop divides weight by weight, in order: the same doubles
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    fixed = np.trunc(w * (1 << _PRECISION_BITS)
                     + np.where(w < 0, -0.5, 0.5)).astype(np.int64)
    return xmin, xmax, fixed


def _pass(img: np.ndarray, axis: int, xmin, xmax, fixed) -> np.ndarray:
    """One direction: out[..., i, ...] = clip8(2^21 + Σ_k in[xmin_i + k]·w_ik
    >> 22) along ``axis`` (0: rows, 1: columns)."""
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((len(xmin),) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    last = src.shape[0] - 1
    for k in range(fixed.shape[1]):
        live = k < xmax
        if not live.any():
            break
        idx = np.minimum(xmin + k, last)
        w = np.where(live, fixed[:, k], 0)
        acc += src[idx] * w.reshape((-1,) + (1,) * (src.ndim - 1))
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: Sequence[int],
                   box: Optional[Sequence[float]] = None) -> np.ndarray:
    """``Image.fromarray(img).resize(size, Image.BICUBIC, box)`` as an
    array: ``img`` uint8 (H, W, 3), ``size`` (width, height)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected uint8 (H, W, C), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    xsize, ysize = int(size[0]), int(size[1])
    if xsize < 1 or ysize < 1:
        raise ValueError(f"height and width must be > 0, got {size}")
    box = tuple(float(np.float32(b)) for b in (box or (0, 0, w, h)))
    if (xsize, ysize) == (w, h) and box == (0.0, 0.0, w, h):
        return img.copy()
    need_h = xsize != w or box[0] != 0 or box[2] != xsize
    need_v = ysize != h or box[1] != 0 or box[3] != ysize
    xs = _coeffs(w, box[0], box[2], xsize)
    ymin, ymax, yk = _coeffs(h, box[1], box[3], ysize)
    out = img
    if need_h:
        # only the rows the vertical pass reads
        first, last = int(ymin[0]), int(ymin[-1] + ymax[-1])
        out = _pass(img[first:last], 1, *xs)
        ymin = ymin - first
    if need_v:
        out = _pass(out, 0, ymin, ymax, yk)
    return out if out is not img else img.copy()
