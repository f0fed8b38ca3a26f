#!/usr/bin/env python3
"""Where a step of the port's Hopper (TMA + wgmma) matmul loop spends its
time, and what a split-K cluster's sum costs, on one CUDA card.

    python3 scripts/torch_wgmma_trace.py

Run from the root of a checkout.  Builds ``csrc/masked_matmul_wgmma.cu``
and ``csrc/int8_matmul_wgmma.cu`` with ``-DWG_TRACE`` (block (0, 0, 0) of
each launch records ``clock64`` at five points of every K step: the
producer's issue of the step's loads, the transform warpgroup seeing them
land, its ``ready`` arrival (the mask, merge or code conversion done), the
first consumer warpgroup starting its wgmmas, and freeing the stage; and
at its fixed points: start, the consumers' loop end, past each of the
split-K sum's two cluster barriers, the sum done, the stores done) into
``build/wgmma_trace/``, then runs, each once to warm up and once traced:
the bool-mask kernel at ViT fc1 calibration (M=32896 K=1408 N=6144), the
sparse-LoRA kernel at ViT fc1 training (M=8224, r=4), the int8 kernel
with no mask and with packed-128 words at ViT fc1 prefill (M=1028,
unsplit), and the bool and int8 + packed-128 kernels at T5 qkvo prefill
(M=288 K=2048 N=2048) on the plan's splits.  Prints the mean SM clocks
of each span over the block's steps after the first (the ring's fill is
in the first), the mean step period, the fixed spans, and the card's
nvidia-smi line.  The traced build is the committed kernel plus the
stores of the trace.
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
from vlm_compression_tpu_torch.ops import bitmask as BM  # noqa: E402
from vlm_compression_tpu_torch.ops import masked_linear as ML  # noqa: E402
from vlm_compression_tpu_torch.ops import quant as Q  # noqa: E402

OUT = ROOT / "build" / "wgmma_trace"


def build(name: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / f"{name}_trace.so"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DWG_TRACE", "-o",
                    str(lib), str(_cuda.CSRC / f"{name}.cu")], check=True)
    out = ctypes.CDLL(str(lib))
    for fn, argtypes in _cuda._SIGNATURES[name].items():
        getattr(out, fn).argtypes = argtypes
        getattr(out, fn).restype = ctypes.c_int
    out.wg_trace_read.argtypes = [ctypes.c_void_p]
    return out


def report(lib, label: str, steps: int, split: bool) -> None:
    """The trace of the last launch: block (0, 0, 0)'s ``steps`` K steps
    (entries past them are an earlier launch's)."""
    buf = np.zeros((6, 1024), dtype=np.int64)
    if lib.wg_trace_read(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise RuntimeError("reading the trace failed")
    issue, landed, ready, start, freed = buf[:5]
    fixed = buf[5]
    g = np.arange(1, steps)
    mean = lambda a, b: float(np.mean(a[g] - b[g]))  # noqa: E731
    period = float(np.mean(np.diff(start[:steps]))) if steps > 1 else 0.0
    line = (f"[{label}] block (0, 0, 0), {steps} K steps, means over steps "
            f"1..{steps - 1}, SM clocks: step period {period:.0f}; issue -> "
            f"landed {mean(landed, issue):.0f}; landed -> ready (transform) "
            f"{mean(ready, landed):.0f}; ready -> consumer start "
            f"{mean(start, ready):.0f}; consumer start -> stage freed "
            f"{mean(freed, start):.0f}; first step: issue -> landed "
            f"{landed[0] - issue[0]}, start -> first wgmma "
            f"{start[0] - fixed[0]}; main loop {fixed[1] - fixed[0]}")
    if split:   # the cluster sum's spans
        line += (f"; split-K sum: wait for the cluster {fixed[2] - fixed[1]}"
                 f", send partials {fixed[3] - fixed[2]}, add "
                 f"{fixed[4] - fixed[3]}, stage + store {fixed[5] - fixed[4]}")
    else:
        line += f"; stage + store {fixed[5] - fixed[1]}"
    print(line, flush=True)


def run(call, lib, label: str, k_split: int, split: bool = False) -> None:
    for _ in range(2):
        rc = call()
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"{label}: launch failed, cudaError {rc}")
    report(lib, label, -(-k_split // 64), split)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_wgmma_trace: no CUDA device", file=sys.stderr)
        return 2
    masked, int8 = build("masked_matmul_wgmma"), build("int8_matmul_wgmma")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def inputs(m, k, n):
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).bfloat16()
        return x, w, torch.rand(k, n, generator=g, device=dev) < 0.5

    m, k, n = 32896, 1408, 6144
    x, w, mask = inputs(m, k, n)
    y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    run(lambda: masked.masked_matmul_wgmma(
        x.data_ptr(), w.data_ptr(), mask.data_ptr(), y.data_ptr(), m, n, k,
        1, k, stream), masked, f"masked M={m} K={k} N={n}", k)

    m, r = 8224, 4
    x, w, mask = inputs(m, k, n)
    a = ((torch.rand(k, r, generator=g, device=dev) * 2 - 1)
         * (6.0 / k) ** 0.5).bfloat16()
    b = (torch.randn(r, n, generator=g, device=dev) * 0.02).bfloat16()
    y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
    run(lambda: masked.sparse_lora_matmul_wgmma(
        x.data_ptr(), w.data_ptr(), mask.data_ptr(), a.data_ptr(),
        b.data_ptr(), r, 16.0 / r, y.data_ptr(), m, n, k, 1, k, stream),
        masked, f"sparse-LoRA M={m} K={k} N={n} r={r}", k)

    for m, k, n in ((1028, 1408, 6144), (288, 2048, 2048)):
        x, w, mask = inputs(m, k, n)
        q, scale = Q.quantize_weight(w)
        packed = BM.pack_mask(mask, 128)
        y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        splits, k_split = ML.plan_wgmma(m, n, k, sms)
        tag = f"M={m} K={k} N={n} splits={splits}"
        if splits > 1:
            run(lambda: masked.masked_matmul_wgmma(
                x.data_ptr(), w.data_ptr(), mask.data_ptr(), y.data_ptr(), m,
                n, k, splits, k_split, stream), masked, f"masked {tag}",
                k_split, True)
        else:
            run(lambda: int8.int8_matmul_wgmma(
                x.data_ptr(), q.data_ptr(), None, 0, 0, scale.data_ptr(),
                y.data_ptr(), m, n, k, splits, k_split, stream), int8,
                f"int8, no mask {tag}", k_split)
        run(lambda: int8.int8_matmul_wgmma(
            x.data_ptr(), q.data_ptr(), packed.data_ptr(), 2, 128,
            scale.data_ptr(), y.data_ptr(), m, n, k, splits, k_split,
            stream), int8, f"int8 + packed-128 {tag}", k_split, splits > 1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
