#!/usr/bin/env python3
"""Which shapes this torch build's ``torch._int_mm`` takes on the card, and
what the W8A8 path's zero padding costs beside it.

    python3 scripts/torch_int_mm_probe.py

Run from the root of a checkout, on one CUDA card.  Calls ``torch._int_mm``
(int8 (M, K) × int8 (K, N) → int32) at M = 1 … 24, 32 and 64, with K and
N each aligned to 8 or not (2048 / 2052, 5120 / 5124), and prints which
calls the build refuses (the first line of its message) and whether every
call it takes is bit-equal to the float64 product of the same codes.  Then
at W8A8's decode-sized rows (M = 4, 5, 20, 40) on a T5-XL FFN shape
(K = 2048, N = 5120) it times ``ops/quant.int_mm`` (the port's padding)
beside ``torch._int_mm`` on the rows as given, where the build takes them
(chip_smoke's ``device_ms``: the median of 20 calls, L2 flushed before
each).  Prints the card's name and power limit first and one JSON line
last.  Exits non-zero if a call the build takes is not exact.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from vlm_compression_tpu_torch.ops import quant as Q  # noqa: E402

ROWS = list(range(1, 25)) + [32, 64]
WIDTHS = [(2048, 5120), (2052, 5120), (2048, 5124)]
TIMED = [4, 5, 20, 40]


def codes(shape, g):
    return torch.randint(-127, 128, shape, generator=g, device="cuda",
                         dtype=torch.int8)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_int_mm_probe: no CUDA device", file=sys.stderr)
        return 2
    print(CS.smi_line(), f"torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    refused, exact, bad = {}, 0, []
    for k, n in WIDTHS:
        b = codes((k, n), g)
        for m in ROWS:
            a = codes((m, k), g)
            try:
                acc = torch._int_mm(a, b)
            except RuntimeError as exc:
                refused[f"{m}x{k}x{n}"] = str(exc).splitlines()[0][:120]
                continue
            if acc.dtype == torch.int32 and torch.equal(
                    acc.double(), a.double() @ b.double()):
                exact += 1
            else:
                bad.append((m, k, n))
    by_width = {f"K={k} N={n}": sorted(int(s.split("x")[0]) for s in refused
                                       if s.endswith(f"x{k}x{n}"))
                for k, n in WIDTHS}
    print(f"refused rows by width: {json.dumps(by_width)}")
    for shape, msg in list(refused.items())[:3]:
        print(f"  e.g. {shape}: {msg}")
    print(f"taken and bit-equal to float64: {exact}; not exact: {bad}")
    k, n = 2048, 5120
    b = codes((k, n), g)
    times = {}
    for m in TIMED:
        a = codes((m, k), g)
        row = {"int_mm_ms": CS.device_ms(lambda: Q.int_mm(a, b))}
        if f"{m}x{k}x{n}" not in refused:
            row["unpadded_ms"] = CS.device_ms(lambda: torch._int_mm(a, b))
        times[m] = row
        print(f"  M={m} K={k} N={n}: {json.dumps(row)}")
    print(json.dumps({"refused": by_width, "exact": exact, "not_exact": bad,
                      "times": times}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
