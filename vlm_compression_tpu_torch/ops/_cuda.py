"""Build and load the hand-written Hopper kernels (route: nvcc + ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc -gencode
arch=compute_90a,code=sm_90a`` into its own shared library with a plain C
interface, at first use, into ``build/kernels/`` at the repository root
(``VCT_TORCH_BUILD_DIR`` overrides it).  The library name carries a hash
of the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds.  Nothing here
runs at import: the CPU tests import every module of the port, and this
host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("masked_matmul", "masked_matmul_wgmma", "matmul_decode",
           "int8_matmul", "int8_matmul_wgmma", "flash_attention",
           "flash_attention_fwd_wgmma", "flash_attention_bwd",
           "flash_attention_bwd_wgmma")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes per C entry point: pointers (and the stream) as c_void_p, or
# ctypes would pass them as 32-bit ints and cut them
_SIGNATURES = {
    "masked_matmul": {
        "masked_matmul_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _P],
        "masked_matmul_f32": [_P, _P, _P, _P, _I, _I, _I, _P],
        "sparse_lora_matmul_bf16": [_P, _P, _P, _P, _P, _I, _F, _P, _P, _I,
                                    _I, _I, _I, _I, _I, _P],
        "sparse_lora_matmul_f32": [_P, _P, _P, _P, _P, _I, _F, _P, _I, _I,
                                   _I, _P],
        "masked_matmul_packed_bf16": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _P],
        "masked_matmul_packed_f32": [_P, _P, _P, _I, _P, _I, _I, _I, _P],
        # fp32 y (a row-parallel shard's unrounded sums), else as the bf16
        # entry points
        "masked_matmul_out32_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                     _I, _P],
        "sparse_lora_matmul_out32_bf16": [_P, _P, _P, _P, _P, _I, _F, _P, _P,
                                          _I, _I, _I, _I, _I, _I, _P],
    },
    # the Hopper loop's entry points take the float32 ones' arguments and
    # the split plan (splits, k_split) before the stream
    "masked_matmul_wgmma": {
        "masked_matmul_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "masked_matmul_packed_wgmma": [_P, _P, _P, _I, _P, _I, _I, _I, _I,
                                       _I, _P],
        "sparse_lora_matmul_wgmma": [_P, _P, _P, _P, _P, _I, _F, _P, _I, _I,
                                     _I, _I, _I, _P],
        "masked_matmul_out32_wgmma": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "sparse_lora_matmul_out32_wgmma": [_P, _P, _P, _P, _P, _I, _F, _P, _I,
                                           _I, _I, _I, _I, _P],
    },
    # the decode-shaped bool, packed and int8 matmuls (one entry point)
    "matmul_decode": {
        "matmul_decode": [_P, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                          _P],
        # bf16 x and w, a bool mask, fp32 y
        "matmul_decode_out32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "int8_matmul": {
        "int8_matmul_bf16": [_P, _P, _P, _I, _I, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _P],
        "int8_matmul_f32": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _P],
    },
    "int8_matmul_wgmma": {
        "int8_matmul_wgmma": [_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                              _P],
    },
    "flash_attention": {
        "flash_attention_fwd": [_I, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _I, _F, _I, _I, _P],
    },
    "flash_attention_fwd_wgmma": {
        "flash_attention_fwd_wgmma": [_P] * 8 + [_I, _I, _I, _I, _I, _F, _I,
                                                 _I, _P],
        # (d, consumer warpgroups) -> blocks an SM of that instantiation
        "flash_attention_fwd_wgmma_blocks_per_sm": [_I, _I],
    },
    "flash_attention_bwd": {
        "flash_attention_bwd_dq": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
        "flash_attention_bwd_dkv": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                                    _P],
        "flash_attention_bwd_dbias": [_I, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                      _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                                      _P],
    },
    "flash_attention_bwd_wgmma": {
        "flash_attention_bwd_delta": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                      _P],
        # ... scale, causal, the two dbias outputs, their scratch, their
        # keep bits, the stream
        "flash_attention_bwd_wgmma": [_P] * 15 + [_I, _I, _I, _I, _I, _F, _I,
                                                  _P, _P, _P, _P, _I, _P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(os.environ.get("VCT_TORCH_BUILD_DIR",
                               _PKG.parent / "build" / "kernels"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False
          ) -> Dict[str, float]:
    """Compile every named source that is not built yet, all at once (one
    nvcc process per source).  Returns seconds per compiled source; raises
    with nvcc's output if any build fails."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, lib, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
            continue
        if verbose and log:
            print(f"--- nvcc {name}.cu\n{log}", flush=True)
        os.replace(tmp, lib)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device`` (a cuda device with an index),
    as the raw cudaStream_t the kernels launch on."""
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


_SM_COUNT: Dict[int, int] = {}


def sm_count(device) -> int:
    """Streaming multiprocessors of ``device`` (cached per device index)."""
    n = _SM_COUNT.get(device.index)
    if n is None:
        import torch

        n = _SM_COUNT[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n
