#!/usr/bin/env python3
"""Where a step of the port's Hopper (TMA + wgmma) matmul loop spends its
time, on one CUDA card.

    python3 scripts/torch_wgmma_trace.py

Run from the root of a checkout.  Builds ``csrc/masked_matmul_wgmma.cu``
with ``-DWG_TRACE`` (block 0 of each launch records ``clock64`` at five
points of every K step: the producer's issue of the step's loads, the
transform warpgroup seeing them land, its ``ready`` arrival, the first
consumer warpgroup starting its wgmmas, and freeing the stage) into
``build/wgmma_trace/``, then runs the bool-mask kernel at ViT fc1
calibration (M=32896 K=1408 N=6144) and the sparse-LoRA kernel at ViT fc1
training (M=8224, r=4), each once to warm up and once traced.  Prints the
mean SM clocks of each span over the block's steps after the first four
(the ring's fill), the mean step period, and the card's nvidia-smi line.
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

from vlm_compression_tpu_torch.ops import _cuda  # noqa: E402

OUT = ROOT / "build" / "wgmma_trace"


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "masked_matmul_wgmma_trace.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DWG_TRACE", "-o",
                    str(lib), str(_cuda.CSRC / "masked_matmul_wgmma.cu")],
                   check=True)
    out = ctypes.CDLL(str(lib))
    for fn, argtypes in _cuda._SIGNATURES["masked_matmul_wgmma"].items():
        getattr(out, fn).argtypes = argtypes
        getattr(out, fn).restype = ctypes.c_int
    out.wg_trace_read.argtypes = [ctypes.c_void_p]
    return out


def report(lib, label: str) -> None:
    buf = np.zeros((6, 1024), dtype=np.int64)
    if lib.wg_trace_read(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise RuntimeError("reading the trace failed")
    issue, landed, ready, start, freed = buf[:5]
    steps = int((start > 0).sum())
    g = np.arange(4, steps)
    mean = lambda a, b: float(np.mean(a[g] - b[g]))  # noqa: E731
    print(f"[{label}] block 0, {steps} K steps, means over steps 4.."
          f"{steps - 1}, SM clocks: step period "
          f"{float(np.mean(np.diff(start[g]))):.0f}; issue -> landed "
          f"{mean(landed, issue):.0f}; landed -> ready (transform) "
          f"{mean(ready, landed):.0f}; ready -> consumer start "
          f"{mean(start, ready):.0f}; consumer start -> stage freed "
          f"{mean(freed, start):.0f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wgmma_trace: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def inputs(m, k, n):
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).bfloat16()
        return x, w, torch.rand(k, n, generator=g, device=dev) < 0.5

    m, k, n = 32896, 1408, 6144
    x, w, mask = inputs(m, k, n)
    y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    for _ in range(2):
        rc = lib.masked_matmul_wgmma(x.data_ptr(), w.data_ptr(),
                                     mask.data_ptr(), y.data_ptr(), m, n, k,
                                     stream)
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    report(lib, f"masked M={m} K={k} N={n}")

    m, r = 8224, 4
    x, w, mask = inputs(m, k, n)
    a = ((torch.rand(k, r, generator=g, device=dev) * 2 - 1)
         * (6.0 / k) ** 0.5).bfloat16()
    b = (torch.randn(r, n, generator=g, device=dev) * 0.02).bfloat16()
    y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    for _ in range(2):
        rc = lib.sparse_lora_matmul_wgmma(
            x.data_ptr(), w.data_ptr(), mask.data_ptr(), a.data_ptr(),
            b.data_ptr(), r, 16.0 / r, y.data_ptr(), m, n, k, stream)
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    report(lib, f"sparse-LoRA M={m} K={k} N={n} r={r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
