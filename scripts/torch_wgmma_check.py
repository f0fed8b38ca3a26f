#!/usr/bin/env python3
"""The Hopper (TMA + wgmma) matmul loop above decode-sized M — bool,
packed, int8 and sparse-LoRA, unsplit and split-K across a cluster —
against the plain versions, then timed beside the WMMA loop and the
library, on one CUDA card.

    python3 scripts/torch_wgmma_check.py [--no-time] [--splits]

Run from the root of a checkout.  Builds the matmul sources (printing
ptxas's registers, shared memory and spills for the two Hopper-loop
sources), then at every prefill shape of chip_smoke.py (``SERVE_SHAPES``
and ``INT8_UNMASKED_SHAPES``), the sparse-LoRA training shapes whose
tiles do not fill the card and two ragged shapes, runs every weight form
through its public wrapper — bool, packed G 128 and 256, int8 with no,
bool, packed-128 and packed-256 masks; sparse-LoRA at its rank — and
prints the loop and splits ``plan`` gave, max |kernel − plain| over
max(1, max |plain|) (chip_smoke's bf16 tolerance is 2e-2), whether packed
≡ bool and int8-masked ≡ int8 on codes zeroed off the mask are bit-equal,
and whether two identical calls are.  Then each form's time
(chip_smoke's ``device_ms``: median of 20 calls, L2 flushed) in turns
(planned, WMMA loop, library, library, WMMA loop, planned; the WMMA loop
forced with ``_loop``; the library ``torch.matmul`` on the weight masked,
merged or dequantized beforehand) beside the bound.  ``--splits`` times
each shape's bool, int8 + packed-128 (or sparse-LoRA) form at every split
count 1-8, for ``plan_wgmma``'s rule.  Exits non-zero if any check fails.
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

FORMS = ("bool", "packed128", "packed256", "int8_none", "int8_bool",
         "int8_packed128", "int8_packed256")
# (name, M, K, N, rank): rank 0 for the weight forms, r for sparse-LoRA
SHAPES = [(name, m, k, n, 0) for name, m, k, n in CS.SERVE_SHAPES
          if not name.endswith("_decode")] + [
    (name, m, k, n, 0) for name, m, k, n in CS.INT8_UNMASKED_SHAPES
    if not name.endswith("_decode")] + [
    (f"lora_{name}", m, k, n, r) for name, m, k, n, r in CS.LORA_SHAPES
    if -(-m // ML.WGMMA_BM) * -(-n // ML.WGMMA_BN) < 132] + [
    ("ragged_m2000_k1000_n1296", 2000, 1000, 1296, 0),
    ("ragged_m100_k2056_n784", 100, 2056, 784, 0)]


class Case:
    """One shape's operands in every form."""

    def __init__(self, m, k, n, rank=0):
        self.m, self.k, self.n, self.rank = m, k, n, rank
        if rank:
            self.x, self.w, self.mask, self.a, self.b = CS.lora_inputs(
                m, k, n, rank, torch.bfloat16)
            self.s = 16.0 / rank
            self.forms = (f"lora_r{rank}",)
            return
        self.x, self.w, self.mask = CS.mm_inputs(m, k, n, torch.bfloat16)
        self.forms = FORMS
        self.q, self.scale = Q.quantize_weight(self.w)
        self.packed = {g: BM.pack_mask(self.mask, g) for g in (128, 256)}

    def mask_of(self, kind):
        if kind.startswith("packed"):
            return self.packed[int(kind[6:])]
        return {"none": None, "bool": self.mask}[kind]

    def call(self, form, loop=None):
        if form.startswith("lora"):
            return ML.sparse_lora_matmul(self.x, self.w, self.mask, self.a,
                                         self.b, self.s, _loop=loop)
        if form == "bool":
            return ML.masked_matmul(self.x, self.w, self.mask, _loop=loop)
        if form.startswith("packed"):
            return ML.masked_matmul_packed(self.x, self.w,
                                           self.packed[int(form[6:])],
                                           _loop=loop)
        return Q.int8_matmul(self.x, self.q, self.scale,
                             self.mask_of(form[5:]), _loop=loop)

    def plain(self, form):
        if form.startswith("lora"):
            return ML.sparse_lora_matmul_ref(self.x, self.w, self.mask,
                                             self.a, self.b, self.s)
        if form == "bool":
            return ML.masked_matmul_ref(self.x, self.w, self.mask)
        if form.startswith("packed"):
            return ML.masked_matmul_packed_ref(self.x, self.w,
                                               self.packed[int(form[6:])])
        return Q.int8_matmul_ref(self.x, self.q, self.scale,
                                 self.mask_of(form[5:]))

    def library(self, form):
        """torch.matmul's operand: the weight masked (merged, dequantized)
        beforehand."""
        if form.startswith("lora"):
            return ML.sparse_lora_weight(self.w, self.mask, self.a, self.b,
                                         self.s)
        if not form.startswith("int8"):
            return self.w * self.mask
        wq = Q.dequantize_weight(self.q, self.scale, torch.bfloat16)
        return wq if form == "int8_none" else wq * self.mask

    def bound(self, form):
        m, k, n = self.m, self.k, self.n
        if form.startswith("lora"):
            return CS.lora_bound_ms(m, k, n, self.rank)
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
    loop, splits, k_split = ML.plan(case.m, case.n, case.k, sms(),
                                    rank=case.rank)
    for form in case.forms:
        before = ML.wgmma_launches
        got = case.call(form)
        ran = ML.wgmma_launches - before
        err, scale = CS.max_err(got, case.plain(form))
        twice = torch.equal(got, case.call(form))
        ok = ran == (loop == ML.WGMMA) and err <= 2e-2 * scale and twice
        bad += not ok
        outs[form] = got
        print(f"  {name:26s} {form:15s} {loop} splits {splits} x "
              f"{k_split}: err/scale {err / scale:.2e}, Hopper launches "
              f"{ran}, two calls {'bit-equal' if twice else 'DIFFER'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
    if case.rank:
        return bad
    for g in (128, 256):
        eq = torch.equal(outs[f"packed{g}"], outs["bool"])
        bad += not eq
        print(f"  {name:26s} packed{g} ≡ bool: {eq}", flush=True)
    zeroed = Q.int8_matmul(case.x, case.q.masked_fill(~case.mask, 0),
                           case.scale)
    for kind in ("int8_bool", "int8_packed128", "int8_packed256"):
        eq = torch.equal(outs[kind], zeroed)
        bad += not eq
        print(f"  {name:26s} {kind} ≡ int8 on zeroed codes, no mask: {eq}",
              flush=True)
    return bad


def sms() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def time_case(name, case) -> None:
    for form in case.forms:
        lib_w = case.library(form)
        fns = (lambda: case.call(form),
               lambda: case.call(form, loop=ML.WMMA),
               lambda: torch.matmul(case.x, lib_w))
        t = [CS.device_ms(f) for f in fns]
        t += [CS.device_ms(f) for f in reversed(fns)]
        new, wmma, lib = (t[0] + t[5]) / 2, (t[1] + t[4]) / 2, \
            (t[2] + t[3]) / 2
        bound, by = case.bound(form)
        print(f"  time {name:26s} {form:15s} Hopper loop {new:.4f} ms "
              f"(turns {t[0]:.4f}/{t[5]:.4f}), WMMA loop {wmma:.4f} "
              f"({wmma / new:.2f}x), library {lib:.4f} (÷ {new / lib:.2f}), "
              f"bound {bound:.5f} ({by}; {new / bound:.1f}x)", flush=True)


def sweep_splits(name, case) -> None:
    """Each split count's time (the forced plan through ``plan_wgmma``),
    against the rule's choice."""
    m, k, n = case.m, case.k, case.n
    chosen = ML.plan_wgmma(m, n, k, sms())
    units = -(-k // ML.WGMMA_K_UNIT)
    saved = ML.plan_wgmma
    forms = case.forms if case.rank else ("bool", "int8_packed128")
    try:
        for form in forms:
            times = []
            for s in range(1, min(ML.WGMMA_MAX_SPLITS, units) + 1):
                per = -(-units // s)
                plan = (1, k) if -(-units // per) == 1 else (
                    -(-units // per), per * ML.WGMMA_K_UNIT)
                if s > 1 and plan[0] != s:
                    continue
                ML.plan_wgmma = lambda *a, plan=plan: plan
                ms = CS.device_ms(lambda: case.call(form))
                times.append(f"{plan[0]}: {ms:.4f}")
            ML.plan_wgmma = saved
            print(f"  splits {name:26s} {form:15s} tiles "
                  f"{-(-m // 256) * -(-n // 128)} units {units} plan "
                  f"{chosen[0]}; ms by splits {', '.join(times)}", flush=True)
    finally:
        ML.plan_wgmma = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wgmma_check: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build(["masked_matmul_wgmma", "int8_matmul_wgmma"], verbose=True)
    _cuda.build(["masked_matmul", "int8_matmul", "matmul_decode"])
    print(f"[device] {CS.smi_line()}", flush=True)
    bad = 0
    cases = {name: Case(m, k, n, r) for name, m, k, n, r in SHAPES}
    for name, case in cases.items():
        bad += check(name, case)
    print(f"[checks] {'all ok' if not bad else f'{bad} FAILED'}", flush=True)
    if bad:
        return 1
    if "--no-time" not in sys.argv:
        for name, case in cases.items():
            time_case(name, case)
    if "--splits" in sys.argv:
        for name, case in cases.items():
            sweep_splits(name, case)
    return 0


if __name__ == "__main__":
    sys.exit(main())
