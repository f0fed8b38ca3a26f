#!/usr/bin/env python3
"""What the two-blocks-per-SM launch bound does to the port's tiled matmul
kernels on one CUDA card.

    python3 scripts/torch_launch_bounds.py

Run from the root of a checkout.  Builds ``csrc/masked_matmul.cu`` and
``csrc/int8_matmul.cu`` twice with ``-Xptxas -v``: as committed
(``__launch_bounds__(THREADS, 2)``, at most 128 registers a thread) and with
the minimum of blocks per SM removed (``__launch_bounds__(THREADS)``).
Prints each bf16 tile kernel's registers and spill stores in both builds,
then times the bool-mask, packed-mask (G 128) and int8 (packed-128 mask)
matmuls through the port's wrappers, on the WMMA loop (forced with
``_loop``), in both builds at the compressed path's prefill and decode
shapes, in the order committed, one-block,
one-block, committed (chip_smoke.py's method: median of 20 calls, CUDA
events, L2 flushed).  The last line is a JSON object of the readings.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
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

SOURCES = ("masked_matmul", "int8_matmul")
OUT = ROOT / "build" / "launch_bounds"
SHAPES = {name: (m, k, n) for name, m, k, n in CS.SERVE_SHAPES
          if name in (CS.PREFILL_TIMED, "t5_wi_decode")}


def variant_sources(variant: str) -> Path:
    """csrc/ as committed, or with the blocks-per-SM minimum removed."""
    d = OUT / variant / "csrc"
    d.mkdir(parents=True, exist_ok=True)
    for f in _cuda.CSRC.iterdir():
        text = f.read_text()
        if variant == "one_block":
            text = text.replace("__launch_bounds__(THREADS, 2)",
                                "__launch_bounds__(THREADS)")
        (d / f.name).write_text(text)
    return d


def build_all():
    """{variant: {source: CDLL}} and {variant: ptxas log}, all four nvcc
    processes at once."""
    procs = {}
    for variant in ("committed", "one_block"):
        src = variant_sources(variant)
        for name in SOURCES:
            lib = OUT / variant / f"{name}.so"
            cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                   str(lib), str(src / f"{name}.cu")]
            procs[(variant, name)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs, logs = {}, {}
    for (variant, name), (proc, lib) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {variant}/{name}.cu failed:\n{out}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _cuda._SIGNATURES[name].items():
            getattr(cdll, fn).argtypes = argtypes
            getattr(cdll, fn).restype = ctypes.c_int
        libs.setdefault(variant, {})[name] = cdll
        logs[variant] = logs.get(variant, "") + out
    return libs, logs


def kernel_name(mangled: str):
    """``masked_matmul_bf16_kernel<VEC, PACKED>`` or
    ``int8_matmul_bf16_kernel<VEC, MASK>`` of a mangled name, else None."""
    m = re.search(r"(masked_matmul|int8_matmul)_bf16_kernelILb(\d)EL[bi](\d)EE",
                  mangled)
    return m and f"{m.group(1)}_bf16_kernel<{m.group(2)}, {m.group(3)}>"


def registers(log: str) -> dict:
    """{bf16 tile kernel: (registers, spill store bytes)} from ptxas -v."""
    out, fn, spill = {}, None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = kernel_name(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out[fn] = (int(m.group(1)), spill)
            fn = None
    return out


def timings(libs) -> dict:
    """{kernel shape: ms} with the given libraries in place."""
    _cuda._LIBS.update(libs)
    out = {}
    for name, (m, k, n) in SHAPES.items():
        x, w, mask = CS.mm_inputs(m, k, n, torch.bfloat16)
        packed = BM.pack_mask(mask, 128)
        q, sc = Q.quantize_weight(w)
        # the WMMA loop, forced where the plan is another loop
        out[f"bool {name}"] = CS.device_ms(
            lambda: ML.masked_matmul(x, w, mask, _loop=ML.WMMA))
        out[f"packed128 {name}"] = CS.device_ms(
            lambda: ML.masked_matmul_packed(x, w, packed, _loop=ML.WMMA))
        out[f"int8_packed128 {name}"] = CS.device_ms(
            lambda: Q.int8_matmul(x, q, sc, packed, _loop=ML.WMMA))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_launch_bounds: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(CS.smi_line(), flush=True)
    libs, logs = build_all()
    regs = {v: registers(log) for v, log in logs.items()}
    for fn in sorted(regs["committed"]):
        print(f"registers, spill stores {fn:34s} committed "
              f"{regs['committed'][fn]}, one_block {regs['one_block'][fn]}",
              flush=True)
    reads = {"committed": [], "one_block": []}
    for variant in ("committed", "one_block", "one_block", "committed"):
        reads[variant].append(timings(libs[variant]))
    for key in reads["committed"][0]:
        c = [r[key] for r in reads["committed"]]
        o = [r[key] for r in reads["one_block"]]
        print(f"{key:32s} committed {c[0]:.4f} {c[1]:.4f} ms, one_block "
              f"{o[0]:.4f} {o[1]:.4f} ms", flush=True)
    print(json.dumps({"registers": regs, "ms": reads}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
