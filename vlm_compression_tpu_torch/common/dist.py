"""Process-group helpers on ``torch.distributed`` (port of
``vlm_compression_tpu/common/dist.py``).

With no process group initialized the program is one process: rank 0,
world size 1, and ``barrier`` does nothing.  ``init_distributed_mode``
joins a group only when the environment names one (``MASTER_ADDR`` with
``RANK`` and ``WORLD_SIZE``); nothing else tells a program of a cluster.
"""

from __future__ import annotations

import functools
import os

import torch

_initialized = False


def _group() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


def init_distributed_mode(run_cfg=None) -> None:
    """Join the process group the environment names (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; NCCL on the card, gloo on
    the CPU); a no-op otherwise, or when ``run_cfg.distributed`` is
    false."""
    global _initialized
    if _initialized or _group():
        _initialized = True
        return
    if run_cfg is not None and not run_cfg.get("distributed", True):
        _initialized = True
        return
    env = os.environ
    if env.get("MASTER_ADDR") and env.get("RANK") is not None and \
            env.get("WORLD_SIZE") is not None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        if backend == "nccl":
            # one card per process, as torchrun numbers them on a host
            torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        torch.distributed.init_process_group(
            backend,
            init_method=(f"tcp://{env['MASTER_ADDR']}:"
                         f"{env.get('MASTER_PORT', '29500')}"),
            rank=int(env["RANK"]), world_size=int(env["WORLD_SIZE"]))
    _initialized = True


def get_world_size() -> int:
    return torch.distributed.get_world_size() if _group() else 1


def get_rank() -> int:
    return torch.distributed.get_rank() if _group() else 0


def is_dist_avail_and_initialized() -> bool:
    return _group() and get_world_size() > 1


def is_main_process() -> bool:
    return get_rank() == 0


def main_process(func):
    """Run only on process 0."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return func(*args, **kwargs)
        return None

    return wrapper


def barrier() -> None:
    """Every process waits for the others (nothing with one process)."""
    if get_world_size() > 1:
        torch.distributed.barrier()


def all_reduce_scalar(value: float, op: str = "sum") -> float:
    """A host scalar reduced over the processes (float64)."""
    if op not in ("sum", "mean", "max"):
        raise ValueError(op)
    if get_world_size() == 1:
        return float(value)
    dev = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    t = torch.tensor([float(value)], dtype=torch.float64, device=dev)
    torch.distributed.all_reduce(
        t, torch.distributed.ReduceOp.MAX if op == "max"
        else torch.distributed.ReduceOp.SUM)
    out = float(t.item())
    return out / get_world_size() if op == "mean" else out
