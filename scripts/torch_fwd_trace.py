#!/usr/bin/env python3
"""Where a kv step of the port's TMA + wgmma attention forward spends its
time, on one CUDA card.

    python3 scripts/torch_fwd_trace.py [SHAPE ...]

Run from the root of a checkout.  Builds ``csrc/flash_attention_fwd_wgmma.cu``
with ``-DFWD_TRACE`` into ``build/fwd_trace/`` (block 0 of the persistent
grid records ``clock64`` at each kv step of its first eight tiles, in its
first consumer warpgroup: K landed, the S product done, the softmax done
and V landed, the P·V product done; and the tile's start, its Q tile
landed, its epilogue issued), then runs the bf16 forward once to warm up
and once traced at each named shape of chip_smoke.py's ``FLASH_SHAPES``
or ``VICUNA_FLASH_SHAPES`` (default: ``vit_self_calib``).  Prints the mean SM clocks of each span
over the traced tiles and their steps, then the card's nvidia-smi line.
The traced build is the committed kernel plus the stores of the trace.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from vlm_compression_tpu_torch.ops import _cuda  # noqa: E402
from vlm_compression_tpu_torch.ops import attention as A  # noqa: E402

OUT = ROOT / "build" / "fwd_trace"


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "flash_attention_fwd_wgmma_trace.so"
    src = _cuda.CSRC / "flash_attention_fwd_wgmma.cu"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DFWD_TRACE", "-o",
                    str(lib), str(src)], check=True)
    out = ctypes.CDLL(str(lib))
    for fn, argtypes in _cuda._SIGNATURES["flash_attention_fwd_wgmma"].items():
        getattr(out, fn).argtypes = argtypes
        getattr(out, fn).restype = ctypes.c_int
    out.fwd_trace_read.argtypes = [ctypes.c_void_p]
    return out


def report(lib, name: str, n_steps: int) -> None:
    buf = np.zeros((8, 6, 8), dtype=np.int64)
    if lib.fwd_trace_read(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise RuntimeError("reading the trace failed")
    spans = {"tile start -> Q landed": [], "waiting for loads": [],
             "S product": [], "softmax": [], "P.V product (rest)": [],
             "epilogue": [], "whole tile": []}
    steps = min(n_steps, 8)
    for tile in buf:
        issue, landed, scores, soft, pv, marks = tile
        start, q_landed, end = marks[:3]
        if end <= 0:
            continue
        spans["tile start -> Q landed"].append(q_landed - start)
        prev = q_landed
        for it in range(steps):
            spans["waiting for loads"].append(landed[it] - prev)
            spans["S product"].append(scores[it] - landed[it])
            spans["softmax"].append(soft[it] - scores[it])
            if pv[it] > 0:
                spans["P.V product (rest)"].append(pv[it] - soft[it])
                prev = pv[it]
            else:
                prev = soft[it]
        spans["epilogue"].append(end - prev)
        spans["whole tile"].append(end - start)
    print(f"[trace] {name}: {len(spans['whole tile'])} tiles of block 0, "
          f"{steps} kv steps each; mean SM clocks: " + "; ".join(
              f"{k} {np.mean(v):.0f}" for k, v in spans.items() if v),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_fwd_trace: no CUDA device", file=sys.stderr)
        return 2
    names = sys.argv[1:] or ["vit_self_calib"]
    lib = build()
    shapes = {s[0]: s[1:] for s in CS.FLASH_SHAPES + CS.VICUNA_FLASH_SHAPES}
    for name in names:
        b, n, m, h, d, kinds, scale = shapes[name]
        q, k, v, biases = CS.flash_inputs(b, n, m, h, d, kinds,
                                          torch.bfloat16)
        strides, ptrs, _ = A._layout(q, k, v, biases)
        out = torch.empty_like(q)
        lse = torch.empty((b, h, n), dtype=torch.float32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(2):
            rc = lib.flash_attention_fwd_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), ptrs[0], ptrs[1],
                (ctypes.c_longlong * 17)(*strides), b, n, m, h, d, scale, 0,
                A._fwd_wgs(n, bool(biases), d), stream)
            torch.cuda.synchronize()
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")
        report(lib, name, -(-m // 64))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
