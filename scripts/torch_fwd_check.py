#!/usr/bin/env python3
"""Both bf16 routes of the port's attention forward against the plain
version, then timed, on one CUDA card.

    python3 scripts/torch_fwd_check.py [--d D]

Run from the root of a checkout.  Builds the forward's sources (printing
ptxas's registers and spills for the TMA + wgmma one) and prints the
blocks an SM the card holds of each instantiation of the TMA + wgmma
kernel (its persistent grid's count), then at every shape of
chip_smoke.py's ``FLASH_SHAPES`` and ``VICUNA_FLASH_SHAPES`` and thirteen
more (causal n = m, n > m and ragged; n = 130 m = 200 at d = 88; a last kv
tile of 16 and of 17 keys; head dims 104 and 120, which pad to 128; at
d = 128 LLaMA's prime with rows that see no valid key, causal n = m = 200
and a last kv tile of 17 keys; the fused-qkv views of the ViT; a row whose
every key is masked) it runs the TMA + wgmma route with
one and (bias-free, d ≤ 96) with three consumer warpgroups a block and the
mma.sync route (forced with ``_impl``), and prints out's and lse's max
|kernel − plain| over max(1, max |plain|) (chip_smoke's bf16 tolerance is
2e-2; lse is held to the same), and whether two identical calls of the
new route are bit-equal.  Then, at the ``FLASH_SHAPES`` and
``VICUNA_FLASH_SHAPES`` shapes, each route's time (chip_smoke's
``device_ms``: median of 20 calls, L2 flushed), in turns (new, old, old,
new), and SDPA's backends beside them.  ``--d D`` keeps the shapes of head
dim D alone.  Exits non-zero if any output is out of tolerance or two
identical calls differ.
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
         ("causal_ragged", 2, 200, 130, 4, 88, [], 0.125, True),
         ("ragged_130_200", 1, 130, 200, 2, 88, ["rel"], 0.1, False),
         ("last_16_keys", 2, 80, 80, 4, 64, ["pad"], 0.125, False),
         ("last_17_keys", 2, 81, 81, 4, 88, ["rel"], 0.1, False),
         ("d_104", 2, 130, 130, 4, 104, ["rel"], 0.1, False),
         ("d_120_causal", 2, 200, 130, 4, 120, [], 0.1, True),
         ("llama_rows_seeing_no_key", 4, 44, 55, 32, 128, ["lpad0"],
          128 ** -0.5, False),
         ("llama_causal_200", 2, 200, 200, 4, 128, [], 128 ** -0.5, True),
         ("llama_last_17_keys", 2, 81, 81, 4, 128, ["cpad"], 128 ** -0.5,
          False)]


def _lse_ref(q, k, biases, scale, causal):
    return torch.logsumexp(A._scores(q, k, biases, scale, causal), -1)


def _wgs(biases, d):
    """The routes to hold: (label, _impl, consumer warpgroups or None);
    three warpgroups a block take bias-free calls at d ≤ 96 only."""
    return [("wgmma1", A.WGMMA, 1)] + (
        [] if biases or d > 96 else [("wgmma3", A.WGMMA, 3)]) + [
        ("mma", A.MMA, None)]


def _call(q, k, v, biases, scale, causal, impl, wgs):
    saved = A._fwd_wgs
    if wgs is not None:
        A._fwd_wgs = lambda n, biased, d: wgs
    try:
        return A.flash_attention(q, k, v, biases, scale, causal, _impl=impl)
    finally:
        A._fwd_wgs = saved


def check_case(name, q, k, v, biases, scale, causal) -> int:
    want = A.mha_reference(q, k, v, biases, scale, causal)
    want_lse = _lse_ref(q, k, biases, scale, causal)
    bad = 0
    for label, impl, wgs in _wgs(biases, q.shape[3]):
        out, lse = _call(q, k, v, biases, scale, causal, impl, wgs)
        e_out = (lambda e: e[0] / e[1])(CS.max_err(out, want))
        e_lse = (lambda e: e[0] / e[1])(CS.max_err(lse, want_lse))
        same = ""
        if impl == A.WGMMA:
            out2, lse2 = _call(q, k, v, biases, scale, causal, impl, wgs)
            equal = torch.equal(out, out2) and torch.equal(lse, lse2)
            same = f" two calls {'bit-equal' if equal else 'DIFFER'}"
            bad += not equal
        ok = e_out <= 2e-2 and e_lse <= 2e-2
        bad += not ok
        print(f"{name:24s} {label:7s} relative err out {e_out:.2e} lse "
              f"{e_lse:.2e}{same} {'ok' if ok else 'FAIL'}", flush=True)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--d", type=int, default=None,
                    help="hold and time the shapes of this head dim alone")
    only = ap.parse_args().d
    if not torch.cuda.is_available():
        print("torch_fwd_check: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    secs = _cuda.build(["flash_attention", "flash_attention_fwd_wgmma"],
                       verbose=True)
    print(f"[build] {secs}", flush=True)
    lib = _cuda.library("flash_attention_fwd_wgmma")
    torch.cuda.init()
    for d, wgs in ((64, 1), (64, 3), (96, 1), (96, 3), (128, 1)):
        print(f"blocks an SM, d <= {d}, {wgs} consumer warpgroup(s): "
              f"{lib.flash_attention_fwd_wgmma_blocks_per_sm(d, wgs)}",
              flush=True)
    bf16 = torch.bfloat16
    bad = 0
    shapes = CS.FLASH_SHAPES + CS.VICUNA_FLASH_SHAPES
    cases = [(name, b, n, m, h, d, kinds, scale, False)
             for name, b, n, m, h, d, kinds, scale in shapes] + EXTRA
    for name, b, n, m, h, d, kinds, scale, causal in cases:
        if only is not None and d != only:
            continue
        q, k, v, biases = CS.flash_inputs(b, n, m, h, d, kinds, bf16)
        bad += check_case(name, q, k, v, biases, scale, causal)
    if only is None or only == 88:
        g = torch.Generator(device="cuda").manual_seed(3)
        qkv = torch.randn(2, 257, 3, 16, 88, generator=g,
                          device="cuda").to(bf16)
        bad += check_case("fused_qkv_views", qkv[:, :, 0], qkv[:, :, 1],
                          qkv[:, :, 2], [], 88 ** -0.5, False)
    if only is None or only == 64:
        q, k, v, _ = CS.flash_inputs(2, 70, 70, 4, 64, [], bf16)
        bias = torch.zeros(2, 1, 70, 70, device="cuda")
        bias[:, :, 5, :] = A.NEG_INF
        bad += check_case("fully_masked_row", q, k, v, [bias], 0.125, False)

    for name, b, n, m, h, d, kinds, scale in shapes:
        if only is not None and d != only:
            continue
        q, k, v, biases = CS.flash_inputs(b, n, m, h, d, kinds, bf16)
        times = {}
        for label, impl, wgs in _wgs(biases, d) + _wgs(biases, d)[::-1]:
            ms = CS.device_ms(lambda: _call(q, k, v, biases, scale, False,
                                            impl, wgs))
            times.setdefault(label, []).append(ms)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        for x in biases:
            mask = x if mask is None else mask + x
        mask = None if mask is None else mask.expand(b, h, n, m).to(bf16)
        lib = CS.sdpa_candidates(lambda be: CS.pinned(
            be, lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, scale=scale)))
        sdpa = {be: (CS.device_ms(fn) if callable(fn) else fn)
                for be, fn in lib.items()}
        bound, by = CS.flash_bound_ms(q, k, v, biases)
        print(f"time {name:22s} " + ", ".join(
            f"{lab} {' / '.join(f'{t:.4f}' for t in ts)}"
            for lab, ts in times.items()) + f" ms; bound {bound:.4f} ({by}); "
            + "; ".join(f"{be} {t:.4f}" if not isinstance(t, str)
                        else f"{be} refused" for be, t in sdpa.items()),
            flush=True)
    print(f"{bad} failures", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
