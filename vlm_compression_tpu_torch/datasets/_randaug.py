"""Pillow's image operations that RandAugment draws from, in numpy, on
uint8 (H, W, 3) RGB arrays.

The card's machine has no Pillow, and the train-time processors run there;
each function is a copy of what Pillow computes, bit for bit:

* ``affine_nearest``: ``Image.transform(size, AFFINE, a)`` with NEAREST
  resampling and fill 0 (libImaging's ``ImagingTransformAffine``): the
  inverse map a = (a0, a1, a2, a3, a4, a5) from output (x, y) to input
  pixel centres; a pure scale (a1 = a3 = 0) takes the scale path (doubles
  from a2 + a0/2, a5 + a4/2, stepped by a0 and a4, −1 below 0, else
  truncated), every other map the 16.16 fixed-point path (each
  coefficient rounded to 1/65536, the row and column steps added as
  integers, the coordinate an arithmetic shift);
* ``rotate``: ``Image.rotate(angle)`` (NEAREST, about the centre, the
  same size): the inverse matrix as ``Image.rotate`` builds it in Python
  floats, then ``affine_nearest``;
* ``autocontrast`` and ``equalize``: ``ImageOps``' per-band look-up
  tables from the histogram (``point`` clips an entry past 255);
* ``blend``: ``Image.blend(a, b, alpha)`` — a + alpha·(b − a) in float32,
  truncated, clipped when alpha lies outside [0, 1];
* ``smooth``: ``image.filter(ImageFilter.SMOOTH)`` — the 3 × 3 kernel
  (1 around, 5 in the centre) divided by 13 in float32, summed row by row
  in float32 from an offset of 0.5 and truncated; the border pixels are
  copied.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

_FIXED_RANGE = 32768.0


def _coord(v: np.ndarray) -> np.ndarray:
    """libImaging's COORD: −1 below 0, else truncated to an int."""
    return np.where(v < 0.0, -1, np.trunc(v)).astype(np.int64)


def _fix(v: float) -> int:
    """16.16 fixed point: floor(v · 65536 + 0.5)."""
    return int(math.floor(v * 65536.0 + 0.5))


def _gather(img: np.ndarray, xin: np.ndarray, yin: np.ndarray
            ) -> np.ndarray:
    h, w = img.shape[:2]
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros_like(img)
    out[ok] = img[yin[ok], xin[ok]]
    return out


def _fits_fixed(a: Sequence[float], x: int, y: int) -> bool:
    return (abs(x * a[0] + y * a[1] + a[2]) < _FIXED_RANGE
            and abs(x * a[3] + y * a[4] + a[5]) < _FIXED_RANGE)


def affine_nearest(img: np.ndarray, a: Sequence[float]) -> np.ndarray:
    """``Image.transform(img.size, Image.AFFINE, a)``, NEAREST, fill 0."""
    a = [float(v) for v in a]
    h, w = img.shape[:2]
    if a[1] == 0 and a[3] == 0:
        # the scale path: one column and one row table, stepped in doubles
        xs = np.add.accumulate(np.concatenate(
            [[a[2] + a[0] * 0.5], np.full(w - 1, a[0])]))
        ys = np.add.accumulate(np.concatenate(
            [[a[5] + a[4] * 0.5], np.full(h - 1, a[4])]))
        xin, yin = np.meshgrid(_coord(xs), _coord(ys))
        return _gather(img, xin, yin)
    if not all(_fits_fixed(a, x, y) for x, y in ((0, 0), (w, h), (0, h),
                                                  (w, 0))):
        raise NotImplementedError("affine map beyond the 16.16 fixed-point "
                                  "range")
    a0, a1, a3, a4 = _fix(a[0]), _fix(a[1]), _fix(a[3]), _fix(a[4])
    a2 = _fix(a[2] + a[0] * 0.5 + a[1] * 0.5)
    a5 = _fix(a[5] + a[3] * 0.5 + a[4] * 0.5)
    x = np.arange(w, dtype=np.int64)[None, :]
    y = np.arange(h, dtype=np.int64)[:, None]
    xx = a2 + y * a1 + x * a0
    yy = a5 + y * a4 + x * a3
    return _gather(img, xx >> 16, yy >> 16)


def rotate(img: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle)``: NEAREST about the centre, the same size."""
    angle = angle % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270) and w == h:
        return np.rot90(img, 1 if angle == 90 else 3).copy()
    center = (w / 2, h / 2)
    angle = -math.radians(angle)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    x, y = -center[0], -center[1]
    m[2], m[5] = m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]
    m[2] += center[0]
    m[5] += center[1]
    return affine_nearest(img, m)


def _apply_lut(img: np.ndarray, luts: Sequence[np.ndarray]) -> np.ndarray:
    out = np.empty_like(img)
    for c in range(img.shape[2]):
        out[..., c] = luts[c][img[..., c]]
    return out


def autocontrast(img: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast(img)`` (no cutoff, nothing ignored)."""
    luts = []
    for c in range(img.shape[2]):
        h = np.bincount(img[..., c].ravel(), minlength=256)
        nz = np.nonzero(h)[0]
        lo, hi = (int(nz[0]), int(nz[-1])) if len(nz) else (255, 0)
        if hi <= lo:
            luts.append(np.arange(256, dtype=np.uint8))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        lut = [min(max(int(ix * scale + offset), 0), 255)
               for ix in range(256)]
        luts.append(np.asarray(lut, np.uint8))
    return _apply_lut(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize(img)``."""
    luts = []
    for c in range(img.shape[2]):
        h = np.bincount(img[..., c].ravel(), minlength=256).tolist()
        histo = [v for v in h if v]
        step = (sum(histo) - histo[-1]) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(np.arange(256, dtype=np.uint8))
            continue
        n, lut = step // 2, []
        for i in range(256):
            lut.append(n // step)
            n += h[i]
        # ``point`` clips a table entry past 255
        luts.append(np.clip(lut, 0, 255).astype(np.uint8))
    return _apply_lut(img, luts)


def blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(a, b, alpha)``."""
    al = np.float32(alpha)
    a32 = a.astype(np.int32)
    t = a32.astype(np.float32) + al * (b.astype(np.int32) - a32).astype(
        np.float32)
    if 0 <= al <= 1.0:
        return t.astype(np.uint8)
    return np.where(t <= 0.0, 0, np.where(t >= 255.0, 255, t)).astype(
        np.uint8)


def smooth(img: np.ndarray) -> np.ndarray:
    """``img.filter(ImageFilter.SMOOTH)``."""
    h, w = img.shape[:2]
    out = img.copy()
    if h < 3 or w < 3:
        return out
    k = (np.float32(1) / np.float32(13), np.float32(5) / np.float32(13))
    f = img.astype(np.float32)

    def row(r, centre):
        # one kernel row over columns 1 .. w−2: (left·k + mid·k') + right·k
        return ((f[r, :-2] * k[0] + f[r, 1:-1] * k[centre])
                + f[r, 2:] * k[0])

    ss = np.full((h - 2, w - 2, img.shape[2]), 0.5, np.float32)
    ss = ss + row(slice(2, None), 0)
    ss = ss + row(slice(1, -1), 1)
    ss = ss + row(slice(None, -2), 0)
    out[1:-1, 1:-1] = np.where(ss <= 0.0, 0, np.where(
        ss >= 255.0, 255, ss)).astype(np.uint8)
    return out
