#!/usr/bin/env python3
"""Where the decode kernel (``csrc/matmul_decode.cu``) spends its time, on
one CUDA card.

    python3 scripts/torch_decode_trace.py [--splits S,...]

Run from the root of a checkout.  Builds the kernel with ``-DDECODE_TRACE``
(block (0, 0) of a launch records ``clock64`` at the producer's issue of
each K step's loads, consumer warp 0 seeing the step land and freeing it,
and at the kernel's start, when every block of the cluster is past its
main loop, when the partials are in block 0 and when the stores are done)
into ``build/decode_trace/``, then
runs the main path's decode shapes (M = 20) in the packed-128 and int8 +
packed-128 forms, each once to warm up and once traced, after a 512 MB
write that evicts the L2 as chip_smoke's timing does.  Prints, in SM
clocks from the kernel's start: when the first step's loads were issued
and landed, the mean issue → land latency, the mean consumer time a step
and the mean wait for a step to land after the previous one was done, when
the main loop ended, and the split-K sum's spans (the wait for the
cluster, the partials' exchange, the sum and stores).  The traced build is
the committed kernel plus the trace's stores.  Then times each case
(chip_smoke's ``device_ms``: median of 20 calls, L2 flushed) on a build
without the trace, at the plan's splits and at each count in ``--splits``.
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
from vlm_compression_tpu_torch.ops import bitmask as BM  # noqa: E402
from vlm_compression_tpu_torch.ops import masked_linear as ML  # noqa: E402
from vlm_compression_tpu_torch.ops import quant as Q  # noqa: E402

OUT = ROOT / "build" / "decode_trace"
SHAPES = [("t5_qkvo_decode", 20, 2048, 2048), ("t5_wi_decode", 20, 2048, 5120),
          ("t5_wo_decode", 20, 5120, 2048)]


def build() -> tuple:
    """(traced, untraced) libraries of the kernel, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    libs, procs = [], []
    for extra in (["-DDECODE_TRACE"], []):
        lib = OUT / f"matmul_decode{'_trace' if extra else ''}.so"
        procs.append(subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *extra, "-o", str(lib),
             str(_cuda.CSRC / "matmul_decode.cu")]))
        libs.append(lib)
    if any(p.wait() for p in procs):
        raise RuntimeError("nvcc failed")
    out = []
    for lib in libs:
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _cuda._SIGNATURES["matmul_decode"].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        out.append(cdll)
    out[0].decode_trace_read.argtypes = [ctypes.c_void_p]
    return tuple(out)


def report(lib, label: str, steps: int) -> None:
    """Block (0, 0)'s spans over its ``steps`` K steps (entries past them
    are an earlier launch's)."""
    buf = np.zeros((4, 256), dtype=np.int64)
    if lib.decode_trace_read(ctypes.c_void_p(buf.ctypes.data)) != 0:
        raise RuntimeError("reading the trace failed")
    issue, landed, done, ep = buf
    t0 = ep[0]
    s = np.arange(steps)
    wait = landed[s[1:]] - done[s[:-1]]
    print(f"[{label}] block (0, 0), {steps} K steps; SM clocks from the "
          f"kernel's start: first issue {issue[0] - t0}, first landed "
          f"{landed[0] - t0}; issue -> landed mean "
          f"{float(np.mean(landed[s] - issue[s])):.0f}; consumer a step "
          f"{float(np.mean(done[s] - landed[s])):.0f}; wait for the next "
          f"step after one is done {float(np.mean(wait)) if len(wait) else 0:.0f}"
          f"; main loop ends {done[steps - 1] - t0}; cluster past its "
          f"main loops {ep[1] - t0}, partials in block 0 +{ep[2] - ep[1]}, "
          f"sum and stores +{ep[3] - ep[2]} (end {ep[3] - t0})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_decode_trace: no CUDA device", file=sys.stderr)
        return 2
    extra_splits = []
    if "--splits" in sys.argv:
        extra_splits = [int(v) for v in
                        sys.argv[sys.argv.index("--splits") + 1].split(",")]
    lib, timed = build()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    flush = torch.empty(512 * 2**20, dtype=torch.int8, device=dev)
    for name, m, k, n in SHAPES:
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w = (torch.randn(k, n, generator=g, device=dev) * k ** -0.5).bfloat16()
        mask = torch.rand(k, n, generator=g, device=dev) < 0.5
        packed = BM.pack_mask(mask, 128)
        q, scale = Q.quantize_weight(w)
        y = torch.empty(m, n, dtype=torch.bfloat16, device=dev)
        for form, wt, w_int8, sc in (("packed128", w, 0, None),
                                     ("int8_packed128", q, 1,
                                      scale.data_ptr())):
            _, splits, k_split = ML.plan_decode(m, n, k, sms, bool(w_int8))
            for _ in range(2):
                flush.zero_()
                rc = lib.matmul_decode(x.data_ptr(), wt.data_ptr(), w_int8,
                                       packed.data_ptr(), 2, 128, sc,
                                       y.data_ptr(), m, n, k, splits,
                                       k_split, stream)
                torch.cuda.synchronize()
                if rc:
                    raise RuntimeError(f"launch failed: cudaError {rc}")
            report(lib, f"{name} {form} M={m} K={k} N={n} splits={splits} "
                   f"k_split={k_split}", -(-min(k_split, k) // 64))
            units = -(-k // ML.DECODE_K_UNIT)
            times = []
            for sp in [splits] + [v for v in extra_splits if v != splits]:
                per = -(-units // min(sp, units))
                sp_, ks = -(-units // per), per * ML.DECODE_K_UNIT

                def call(sp_=sp_, ks=ks):
                    timed.matmul_decode(x.data_ptr(), wt.data_ptr(), w_int8,
                                        packed.data_ptr(), 2, 128, sc,
                                        y.data_ptr(), m, n, k, sp_, ks,
                                        stream)
                times.append(f"{sp_} splits {CS.device_ms(call):.4f} ms")
            print(f"  time {name} {form}: {'; '.join(times)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
