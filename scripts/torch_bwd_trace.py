#!/usr/bin/env python3
"""Where a q step of the port's TMA + wgmma attention backward spends its
time, on one CUDA card.

    python3 scripts/torch_bwd_trace.py [SHAPE]

Run from the root of a checkout.  Builds ``csrc/flash_attention_bwd_wgmma.cu``
with ``-DBWD_TRACE`` (block (0, 0, 0) of each launch records ``clock64`` at
six points of every q step: the producer's issue of the step's loads, the
consumer warpgroup seeing them land, its Sᵀ and dPᵀ products done, the
elementwise pass and the dSᵀ tile stored, the dV, dK and dQ products done,
and the dQ tile stored into its slab; at d = 128 the points are the dK
warpgroup's: its "elementwise" span includes storing Pᵀ and dSᵀ, its
"products" span is dK's alone and "dQ stored" follows it at once, since
the other consumer runs the dV and dQ products and stores dQ) into
``build/bwd_trace/``,
then runs the bf16 backward at a shape of chip_smoke.py's ``BWD_SHAPES``
(default ``vit_self``: b=32 n=m=257 h=16 d=88; ``llama_self``: LLaMA's
d = 128 under its causal + pad bias) once to warm up and once traced.  Prints the mean SM clocks of each
span over the block's q steps, then the device time of each of the three passes
(pre-pass, main kernel, dq cast) from torch.profiler over 10 calls of the
committed build, and the card's nvidia-smi line.  The traced build is the
committed kernel plus the stores of the trace.
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

OUT = ROOT / "build" / "bwd_trace"


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    lib = OUT / "flash_attention_bwd_wgmma_trace.so"
    src = _cuda.CSRC / "flash_attention_bwd_wgmma.cu"
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-DBWD_TRACE", "-o",
                    str(lib), str(src)], check=True)
    out = ctypes.CDLL(str(lib))
    for fn, argtypes in _cuda._SIGNATURES["flash_attention_bwd_wgmma"].items():
        getattr(out, fn).argtypes = argtypes
        getattr(out, fn).restype = ctypes.c_int
    out.bwd_trace_read.argtypes = [ctypes.c_void_p]
    return out


def report(lib) -> None:
    buf = np.zeros((6, 64), dtype=np.int64)
    if lib.bwd_trace_read(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise RuntimeError("reading the trace failed")
    issue, landed, scores, stored, products, done = buf
    steps = int((done > 0).sum())
    g = np.arange(steps)
    mean = lambda a, b: float(np.mean(a[g] - b[g]))  # noqa: E731
    period = float(np.mean(np.diff(landed[g]))) if steps > 1 else float("nan")
    waited = float(np.mean(landed[1:steps] - done[:steps - 1])) \
        if steps > 1 else float("nan")
    print(f"[trace] block (0, 0, 0), {steps} q steps, means, SM clocks: "
          f"step period {period:.0f}; issue -> landed "
          f"{mean(landed, issue):.0f}; Sᵀ and dPᵀ products "
          f"{mean(scores, landed):.0f}; elementwise + dSᵀ store + barrier "
          f"{mean(stored, scores):.0f}; dV, dK, dQ products "
          f"{mean(products, stored):.0f}; dQ store into its slab "
          f"{mean(done, products):.0f}; waiting for the next step's "
          f"loads {waited:.0f}", flush=True)


def passes(args) -> None:
    """Device time of each pass over 10 calls of the committed build."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        A.flash_attention_backward(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            A.flash_attention_backward(*args)
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.duration_ns() <= 0:
            continue
        name = e.name()
        key = ("pre-pass" if "flash_bwd_delta" in name else
               "main kernel" if "flash_bwd_wgmma" in name else
               "dq cast" if "flash_bwd_dq_cast" in name else "other")
        by[key] = by.get(key, 0.0) + e.duration_ns() / 1e6 / 10
    print("[passes] device ms a call (L2 warm, back to back): " + ", ".join(
        f"{k} {v:.4f}" for k, v in by.items()), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bwd_trace: no CUDA device", file=sys.stderr)
        return 2
    lib = build()
    dev = torch.device("cuda")
    name = sys.argv[1] if len(sys.argv) > 1 else "vit_self"
    _, b, n, m, h, d, kinds, scale = next(c for c in CS.BWD_SHAPES
                                          if c[0] == name)
    q, k, v, biases = CS.flash_inputs(b, n, m, h, d, kinds, torch.bfloat16)
    g = CS.grad_like(q)
    out, lse = A.flash_attention(q, k, v, biases, scale)
    layout, ptrs, _ = A._layout(q, k, v, biases)
    n_pad = -(-n // 64) * 64
    pads = torch.empty((2, b, h, n_pad), dtype=torch.float32, device=dev)
    ws = torch.empty((-(-m // 64), b, h, n_pad, A._head_pad(d)),
                     dtype=torch.float32, device=dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 23)(*layout, *g.stride()[:3],
                                       *out.stride()[:3])
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(2):
        rc = lib.flash_attention_bwd_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            out.data_ptr(), lse.data_ptr(), pads[0].data_ptr(),
            pads[1].data_ptr(), ws.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ptrs[0], ptrs[1], strides, b, n, m, h, d, scale,
            0, None, None, None, None, 0, stream)
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"launch failed: cudaError {rc}")
    print(f"{name}: b={b} n={n} m={m} h={h} d={d} biases={kinds}",
          flush=True)
    report(lib)
    passes((q, k, v, out, lse, g, biases, scale))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
