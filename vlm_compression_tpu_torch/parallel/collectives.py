"""Explicit collectives of the port's tensor, data and pipeline parallelism.

The JAX package needs none of this: GSPMD inserts the collectives of a
sharded program.  The port runs one process per device and writes them
out, Megatron's way:

  copy_to      identity forward, all-reduce of the gradient: the input of
               a column-parallel linear ("f")
  reduce_from  all-reduce forward, identity backward: the output of a
               row-parallel linear ("g")
  scatter_last this rank's chunk of the last dim forward, all-gather of the
               gradient: a whole input entering a row-parallel linear

Both all-reduces sum in float32 and round the sum once.  A row-parallel
linear hands ``reduce_from`` its products' fp32 sums (the kernels' fp32
output) and the compute dtype to round to, so its output is rounded once,
as one process rounds it.

``group`` None (or a group of one) makes every one of them the identity.
Gloo takes CUDA tensors for all-reduce, broadcast and all-gather but not
for send / recv: ``send`` and ``recv`` stage a CUDA tensor through the host
under gloo.  ``spawn`` starts ranks for the tests and the card's smoke
script.
"""

from __future__ import annotations

import datetime
import os
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

# what gloo staged through the host: the pipeline's hops (send + recv),
# and the collectives on CUDA tensors with their bytes (each rank's
# tensor once)
HOST_STAGED = {"hops": 0, "collectives": 0, "bytes": 0}


def _tally(t: torch.Tensor) -> None:
    if _staged(t):
        HOST_STAGED["collectives"] += 1
        HOST_STAGED["bytes"] += t.numel() * t.element_size()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_gather_dim(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """The group's tensors concatenated along ``dim``, in group-rank order
    (no gradient)."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    _tally(t)
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce_(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place over the group (nothing for a group of one)."""
    if group_size(group) > 1:
        _tally(t)
        dist.all_reduce(t, op=op, group=group)
    return t


def chunk(t: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """This rank's equal chunk of ``t`` along ``dim``."""
    n = group_size(group)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, group_rank(group) * size, size)


def reduce_scatter_dim(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Sum over the group, then this rank's chunk along ``dim`` (gloo has no
    reduce-scatter: an all-reduce and a slice)."""
    out = all_reduce_(t.clone(), group)
    return chunk(out, group, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # the partial input gradients summed in float32, the sum rounded
        # once
        return all_reduce_(g.float().contiguous().clone(),
                           ctx.group).to(g.dtype), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.in_dtype = x.dtype
        y = x.float().contiguous()
        if y is x:
            y = y.clone()
        return all_reduce_(y, group).to(dtype or x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.in_dtype), None, None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return chunk(x, group, -1).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.group, -1), None


def copy_to(x, group):
    return x if group_size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x, group, dtype=None):
    """The sum of ``x`` over the group, in float32, rounded once to
    ``dtype`` (default ``x``'s)."""
    if group_size(group) == 1:
        return x if dtype is None else x.to(dtype)
    return _ReduceFrom.apply(x, group, dtype)


def scatter_last(x, group):
    return x if group_size(group) == 1 else _ScatterLast.apply(x, group)


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def send(t: torch.Tensor, dst: int, tag: int = 0) -> None:
    """Point-to-point send (global rank), through the host under gloo."""
    if _staged(t):
        HOST_STAGED["hops"] += 1
        t = t.cpu()
    dist.send(t.contiguous(), dst, tag=tag)


def recv(shape, dtype, device, src: int, tag: int = 0) -> torch.Tensor:
    """Point-to-point receive of a tensor of ``shape`` (global rank)."""
    dev = torch.device(device)
    staged = dev.type == "cuda" and dist.get_backend() == "gloo"
    buf = torch.empty(shape, dtype=dtype,
                      device="cpu" if staged else dev)
    dist.recv(buf, src, tag=tag)
    return buf.to(dev) if staged else buf


def broadcast_(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """In place from global rank ``src`` over the group."""
    if group_size(group) > 1:
        _tally(t)
        dist.broadcast(t, src, group=group)
    return t


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def _to_host(obj):
    """Tensors → numpy, recursively: results cross the process boundary by
    value (a shared-memory tensor dies with the rank that made it)."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, world, backend, init_method, timeout, fn, args,
               results):
    ok, out = False, None
    try:
        torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        out = _to_host(fn(rank, world, *args))
        ok = True
    except BaseException:           # reported to the parent, which raises
        out = traceback.format_exc()
    finally:
        results.put((rank, ok, out))
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, backend: str = "gloo",
          init_file: Optional[str] = None, timeout: float = 60.0,
          args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` fresh processes (start
    method ``spawn``) joined in one process group (``init_method=file://``
    at ``init_file``, a path that must not exist yet); returns the ranks'
    results in rank order, tensors as numpy.  ``timeout`` bounds the group's
    collectives and the wait for the ranks; a rank that fails, or a wait
    that runs out, raises here with the rank's traceback, and no rank
    outlives the call.  ``fn`` must be importable by name (a module-level
    function).  Each rank runs on one CPU thread."""
    import torch.multiprocessing as mp

    if init_file is None:
        raise ValueError("spawn needs an init_file path")
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, backend,
                               "file://" + os.path.abspath(init_file),
                               timeout, fn, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < world:
            if not results.empty():
                rank, ok, out = results.get()
                got[rank] = (ok, out)
                if not ok:
                    break
                continue
            if time.monotonic() > deadline:
                break
            if any(not p.is_alive() and p.exitcode not in (0, None)
                   for p in procs) and results.empty():
                time.sleep(0.5)
                if results.empty():
                    break
            time.sleep(0.02)
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    failed = [(r, out) for r, (ok, out) in sorted(got.items()) if not ok]
    if failed:
        raise RuntimeError("rank(s) failed:\n" + "\n".join(
            f"--- rank {r}\n{out}" for r, out in failed))
    if len(got) < world:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"spawn: {world - len(got)} rank(s) returned "
                           f"nothing within {timeout:.0f} s (exit codes "
                           f"{codes})")
    return [got[r][1] for r in range(world)]


__all__ = ["all_gather_dim", "all_reduce_", "broadcast_", "chunk",
           "copy_to", "group_rank", "group_size", "recv",
           "reduce_from", "reduce_scatter_dim", "scatter_last", "send",
           "spawn", "HOST_STAGED"]
