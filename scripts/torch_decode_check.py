#!/usr/bin/env python3
"""The decode kernel (``csrc/matmul_decode.cu``) against the plain versions,
then timed beside the WMMA loop and the library, on one CUDA card.

    python3 scripts/torch_decode_check.py [--no-time]

Run from the root of a checkout.  Builds the matmul sources (printing
ptxas's registers, shared memory and spills for the decode kernel), then
at the main path's decode shapes (chip_smoke.py's ``SERVE_SHAPES`` and the
int8 LM head) and two ragged ones, at M = 1, 7, 20 and 64, runs every
weight form through its public wrapper — bool, packed G 128 and 256,
int8 with no, bool and packed-128 masks — and prints max |kernel − plain|
over max(1, max |plain|) (chip_smoke's bf16 tolerance is 2e-2), whether
packed ≡ bool and int8-masked ≡ int8 on codes zeroed off the mask are
bit-equal, and whether two identical calls are.  Then, at M = 20, each
form's time (chip_smoke's ``device_ms``: median of 20 calls, L2 flushed)
in turns (decode, WMMA loop, library, library, WMMA loop, decode; the WMMA
loop forced with ``_loop``; the library ``torch.matmul`` on the weight
masked and dequantized beforehand) beside the bound.  Exits non-zero if
any check fails.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from vlm_compression_tpu_torch.ops import _cuda  # noqa: E402
from vlm_compression_tpu_torch.ops import bitmask as BM  # noqa: E402
from vlm_compression_tpu_torch.ops import masked_linear as ML  # noqa: E402
from vlm_compression_tpu_torch.ops import quant as Q  # noqa: E402

SHAPES = [(name, k, n) for name, m, k, n in CS.SERVE_SHAPES
          if name.endswith("_decode")] + [
    ("ragged_k1000_n2064", 1000, 2064), ("ragged_k2056_n784", 2056, 784)]
LM_HEAD = ("lm_head_decode", 2048, 32128)
FORMS = ("bool", "packed128", "packed256", "int8_none", "int8_bool",
         "int8_packed128")


class Case:
    """One shape's operands in every form."""

    def __init__(self, m, k, n, forms=FORMS):
        self.x, w, self.mask = CS.mm_inputs(m, k, n, torch.bfloat16)
        self.w, self.forms = w, forms
        self.q, self.scale = Q.quantize_weight(w)
        self.packed = {g: BM.pack_mask(self.mask, g) for g in (128, 256)}
        self.m, self.k, self.n = m, k, n

    def mask_of(self, kind):
        return {"none": None, "bool": self.mask}.get(
            kind, self.packed.get(int(kind[6:])) if kind.startswith("packed")
            else None)

    def call(self, form, loop=None):
        if form == "bool":
            return ML.masked_matmul(self.x, self.w, self.mask, _loop=loop)
        if form.startswith("packed"):
            return ML.masked_matmul_packed(self.x, self.w,
                                           self.packed[int(form[6:])],
                                           _loop=loop)
        return Q.int8_matmul(self.x, self.q, self.scale,
                             self.mask_of(form[5:]), _loop=loop)

    def plain(self, form):
        if form == "bool":
            return ML.masked_matmul_ref(self.x, self.w, self.mask)
        if form.startswith("packed"):
            return ML.masked_matmul_packed_ref(self.x, self.w,
                                               self.packed[int(form[6:])])
        return Q.int8_matmul_ref(self.x, self.q, self.scale,
                                 self.mask_of(form[5:]))

    def library(self, form):
        """torch.matmul's operand: the weight masked (and dequantized)
        beforehand."""
        if not form.startswith("int8"):
            return self.w * self.mask
        wq = Q.dequantize_weight(self.q, self.scale, torch.bfloat16)
        return wq if form == "int8_none" else wq * self.mask

    def bound(self, form):
        m, k, n = self.m, self.k, self.n
        if form == "bool":
            return CS.mm_bound_ms(m, k, n)
        if form.startswith("packed"):
            return CS.packed_bound_ms(m, k, n, 256 // int(form[6:]))
        kind = form[5:]
        mask_bytes = {"none": 0, "bool": k * n}.get(
            kind, k * n * (256 // int(kind[6:] or 128)) / 8)
        return CS.int8_bound_ms(m, k, n, mask_bytes)


def check(name, case) -> int:
    bad = 0
    outs = {}
    for form in case.forms:
        before = ML.decode_launches
        got = case.call(form)
        ran = ML.decode_launches - before
        err, scale = CS.max_err(got, case.plain(form))
        twice = torch.equal(got, case.call(form))
        ok = ran == 1 and err <= 2e-2 * scale and twice
        bad += not ok
        outs[form] = got
        print(f"  {name:20s} M={case.m:2d} {form:15s} err/scale "
              f"{err / scale:.2e} decode launches {ran} two calls "
              f"{'bit-equal' if twice else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if "bool" in outs:
        for g in (128, 256):
            if f"packed{g}" in outs:
                eq = torch.equal(outs[f"packed{g}"], outs["bool"])
                bad += not eq
                print(f"  {name:20s} M={case.m:2d} packed{g} ≡ bool: {eq}")
    zeroed = case.q.masked_fill(~case.mask, 0)
    if "int8_bool" in outs:
        plain = Q.int8_matmul(case.x, zeroed, case.scale)
        for kind in ("int8_bool", "int8_packed128"):
            eq = torch.equal(outs[kind], plain)
            bad += not eq
            print(f"  {name:20s} M={case.m:2d} {kind} ≡ int8 on zeroed "
                  f"codes, no mask: {eq}")
    return bad


def time_case(name, case) -> None:
    for form in case.forms:
        lib_w = case.library(form)
        fns = (lambda: case.call(form),
               lambda: case.call(form, loop=ML.WMMA),
               lambda: torch.matmul(case.x, lib_w))
        t = [CS.device_ms(f) for f in fns]
        t += [CS.device_ms(f) for f in reversed(fns)]
        dec, wmma, lib = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, \
            (t[2] + t[3]) / 2
        bound, by = case.bound(form)
        print(f"  time {name:16s} M={case.m} {form:15s} decode {dec:.4f} ms "
              f"(turns {t[0]:.4f}/{t[5]:.4f}), WMMA loop {wmma:.4f} "
              f"({wmma / dec:.2f}x), library {lib:.4f} (÷ {dec / lib:.2f}), "
              f"bound {bound:.5f} ({by}; {dec / bound:.1f}x)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build(["matmul_decode"], verbose=True)
    _cuda.build(["masked_matmul", "int8_matmul"])
    print(f"[device] {CS.smi_line()}", flush=True)
    bad = 0
    for m in (1, 7, 20, 64):
        for name, k, n in SHAPES:
            bad += check(name, Case(m, k, n))
        name, k, n = LM_HEAD
        bad += check(name, Case(m, k, n, forms=("int8_none",)))
    if "--no-time" not in sys.argv:
        for name, k, n in SHAPES[:3]:
            time_case(name, Case(20, k, n))
        name, k, n = LM_HEAD
        time_case(name, Case(20, k, n, forms=("int8_none",)))
    print(f"[checks] {'all ok' if not bad else f'{bad} FAILED'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
