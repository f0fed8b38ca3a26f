#!/usr/bin/env python3
"""Both bf16 routes of the port's attention backward against the plain
version, then timed, on one CUDA card.

    python3 scripts/torch_bwd_check.py [--d D]

Run from the root of a checkout.  Builds the backward's sources (printing
ptxas's registers and spills for the TMA + wgmma one), then at every
shape of chip_smoke.py's ``BWD_SHAPES`` and ten more (causal n = m and
n > m, ragged n = m = 200, ragged causal n = 200 m = 130, the T5
decoder's position bias with its additive causal mask; at LLaMA's d = 128
four q and kv tiles under its causal + pad bias, causal n = m and n > m;
head dims 104 and 120, which pad to 128), for dq, dk and dv together, dq
alone and dk/dv alone, it runs the TMA + wgmma route and the mma.sync
route (forced with ``_impl``) from the same forward's out and lse, and
prints each gradient's max |kernel − plain| over max(1, max |plain|)
(chip_smoke's bf16 tolerance is 2e-2) and whether two identical calls of
the TMA + wgmma route are bit-equal.  Then, at the ``BWD_SHAPES`` shapes,
the whole backward's time on each route (chip_smoke's ``device_ms``:
median of 20 calls, L2 flushed), the new route twice around the old one.
``--d D`` keeps the shapes of head dim D alone.  Exits non-zero if any
gradient is out of tolerance or two identical calls differ.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from vlm_compression_tpu_torch.ops import _cuda  # noqa: E402
from vlm_compression_tpu_torch.ops import attention as A  # noqa: E402

EXTRA = [("causal_n_eq_m", 2, 40, 40, 4, 64, [], 0.125, True),
         ("causal_n_gt_m", 2, 9, 5, 4, 64, [], 0.125, True),
         ("ragged_200", 2, 200, 200, 4, 88, ["rel"], 0.125, False),
         ("ragged_causal", 2, 200, 130, 4, 64, [], 0.125, True),
         ("relc_70", 2, 70, 70, 4, 64, ["relc", "pad"], 1.0, False),
         ("llama_cpad_200", 2, 200, 200, 8, 128, ["cpad"], 128 ** -0.5,
          False),
         ("llama_causal_200", 2, 200, 200, 4, 128, [], 128 ** -0.5, True),
         ("llama_causal_200_130", 2, 200, 130, 4, 128, [], 128 ** -0.5,
          True),
         ("d_104", 2, 130, 130, 4, 104, ["rel"], 0.1, False),
         ("d_120_causal", 2, 200, 130, 4, 120, [], 0.1, True)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=None,
                    help="hold and time the shapes of this head dim alone")
    only = ap.parse_args().d
    if not torch.cuda.is_available():
        print("torch_bwd_check: no CUDA device", file=sys.stderr)
        return 2
    secs = _cuda.build(["flash_attention_bwd", "flash_attention_bwd_wgmma"],
                       verbose=True)
    print(f"[build] {secs}", flush=True)
    # the training shapes both bf16 routes take
    shapes = [c for c in CS.BWD_SHAPES if A.plan(*c[2:4], c[5]) == A.WGMMA
              and (only is None or c[5] == only)]
    cases = [(name, b, n, m, h, d, kinds, scale, False)
             for name, b, n, m, h, d, kinds, scale in shapes] + [
        c for c in EXTRA if only is None or c[5] == only]
    bad = 0
    for name, b, n, m, h, d, kinds, scale, causal in cases:
        q, k, v, biases = CS.flash_inputs(b, n, m, h, d, kinds,
                                          torch.bfloat16)
        g = CS.grad_like(q)
        out, lse = A.flash_attention(q, k, v, biases, scale, causal)
        want = A.flash_attention_backward_ref(q, k, v, out, lse, g, biases,
                                              scale, causal)
        for impl in (A.WGMMA, A.MMA):
            for need in ((True, True), (True, False), (False, True)):
                got = A.flash_attention_backward(
                    q, k, v, out, lse, g, biases, scale, causal, *need,
                    _impl=impl)
                errs = [None if x is None else
                        (lambda e: e[0] / e[1])(CS.max_err(x, y))
                        for x, y in zip(got, want)]
                ok = all(e is None or e <= 2e-2 for e in errs)
                same = ""
                if impl == A.WGMMA and all(need):
                    again = A.flash_attention_backward(
                        q, k, v, out, lse, g, biases, scale, causal, *need,
                        _impl=impl)
                    equal = all(torch.equal(x, y) for x, y in zip(got, again))
                    same = f" two calls {'bit-equal' if equal else 'DIFFER'}"
                    ok = ok and equal
                bad += not ok
                print(f"{name:20s} {impl:5s} dq={need[0]} dkv={need[1]} "
                      f"relative err dq/dk/dv "
                      f"{'/'.join('-' if e is None else f'{e:.2e}' for e in errs)}"
                      f"{same} {'ok' if ok else 'FAIL'}", flush=True)
    for name, b, n, m, h, d, kinds, scale in shapes:
        q, k, v, biases = CS.flash_inputs(b, n, m, h, d, kinds,
                                          torch.bfloat16)
        g = CS.grad_like(q)
        out, lse = A.flash_attention(q, k, v, biases, scale)
        args = (q, k, v, out, lse, g, biases, scale)
        new1 = CS.device_ms(lambda: A.flash_attention_backward(
            *args, _impl=A.WGMMA))
        old = CS.device_ms(lambda: A.flash_attention_backward(
            *args, _impl=A.MMA))
        new2 = CS.device_ms(lambda: A.flash_attention_backward(
            *args, _impl=A.WGMMA))
        bound, by = CS.flash_bwd_bound_ms(q, k, v, biases)
        print(f"time {name}: TMA + wgmma {new1:.4f} / {new2:.4f} ms, "
              f"mma.sync {old:.4f} ms; bound {bound:.4f} ({by})", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    print(f"{bad} failures", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
