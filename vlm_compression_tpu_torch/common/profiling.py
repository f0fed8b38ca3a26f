"""Tracing and profiling helpers (port of
``vlm_compression_tpu/common/profiling.py``): wall-clock per call, per-phase
seconds and live device memory written to
``output_dir/training_statistics/<job>.yaml``, and a ``torch.profiler``
capture around a region."""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import time
from typing import Dict, Optional

import torch


def device_live_bytes() -> int:
    """Bytes the caching allocator holds in live tensors on the card (0
    without a card)."""
    if not torch.cuda.is_available():
        return 0
    return int(torch.cuda.memory_allocated())


def print_time(func):
    """Log the wall-clock of every call."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = func(*args, **kwargs)
        logging.info("%s took %.2fs", func.__qualname__,
                     time.perf_counter() - t0)
        return out

    return wrapper


def _yaml_scalar(v) -> str:
    """A scalar as ``yaml.safe_dump`` writes it (floats keep a dot before
    the exponent, as YAML 1.1 needs)."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    return json.dumps(str(v))


class PhaseTimer:
    """Collects {phase_seconds, phase_live_gb} and writes the training-
    statistics artifact."""

    def __init__(self):
        self.stats: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, trace: bool = False):
        ctx = (torch.profiler.record_function(name) if trace
               else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.stats[f"{name}_seconds"] = round(time.perf_counter() - t0, 3)
        self.stats[f"{name}_live_gb"] = round(
            device_live_bytes() / 2 ** 30, 3)

    def dump(self, output_dir: str, job_id: str,
             extra: Optional[Dict] = None) -> str:
        """A flat YAML mapping, keys sorted as ``yaml.safe_dump`` sorts
        them."""
        os.makedirs(os.path.join(output_dir, "training_statistics"),
                    exist_ok=True)
        path = os.path.join(output_dir, "training_statistics",
                            f"{job_id}.yaml")
        payload = dict(self.stats)
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            for k in sorted(payload):
                f.write(f"{k}: {_yaml_scalar(payload[k])}\n")
        return path


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A ``torch.profiler`` capture (the card's kernels too, where there is
    a card) around a region when ``log_dir`` is set, written there as a
    Chrome trace."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
