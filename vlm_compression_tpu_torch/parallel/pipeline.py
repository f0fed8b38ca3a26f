"""GPipe pipeline parallelism over a ``pipe`` mesh axis (port of
``vlm_compression_tpu/parallel/pipeline.py``).

The repeated blocks stack into one stage-major tree: every tensor gains a
leading ``(n_stages, layers_per_stage)`` axis pair, and each pipe rank holds
its own stage's slab (``shard_stages``).  ``pipeline_apply`` runs the GPipe
schedule: stage 0 injects the microbatches, every stage applies its local
layers to each in turn, and activations hop stage → stage.  The hops are
autograd Functions (a send's backward receives the activation's gradient
from the next stage, a receive's backward sends it back), so autograd
through ``pipeline_apply`` is the GPipe backward and gives the sequential
gradient; the microbatches' backwards run in reverse order on every stage,
which is the order autograd takes them (each one's nodes were made after
the one before).  The output has ``x``'s shape and is on every pipe rank,
broadcast from the last stage.  ``torch.distributed.pipelining``'s
schedules own the backward and the loss, which would break that contract;
none is used.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch
import torch.distributed as dist

from vlm_compression_tpu_torch.parallel import collectives as C
from vlm_compression_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
)


def _params_of(layer) -> Dict[str, torch.Tensor]:
    if isinstance(layer, torch.nn.Module):
        return dict(layer.named_parameters())
    return dict(layer)


def stack_layer_params(layer_params: Sequence[Any]) -> Dict[str, torch.Tensor]:
    """Per-layer parameters (modules or {name: tensor}) → {name: tensor}
    with a leading layer axis of size ``len(layer_params)``."""
    trees = [_params_of(p) for p in layer_params]
    return {k: torch.stack([t[k].detach() for t in trees])
            for k in trees[0]}


def split_stages(stacked: Dict[str, torch.Tensor], n_stages: int
                 ) -> Dict[str, torch.Tensor]:
    """(L, …) → (n_stages, L // n_stages, …); raises where L does not
    divide."""
    out = {}
    for k, x in stacked.items():
        L = x.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers not divisible by {n_stages} stages")
        out[k] = x.reshape((n_stages, L // n_stages) + tuple(x.shape[1:]))
    return out


def stage_spec(staged: Dict[str, torch.Tensor]) -> Dict[str, tuple]:
    """The spec of every staged tensor: its stage axis on ``pipe``."""
    return {k: ("pipe",) for k in staged}


def shard_stages(staged: Dict[str, torch.Tensor], mesh,
                 requires_grad: bool = False) -> Dict[str, torch.Tensor]:
    """This pipe rank's stage: {name: (layers_per_stage, …)} leaves."""
    s = axis_index(mesh, "pipe")
    return {k: x[s].detach().clone().requires_grad_(requires_grad)
            for k, x in staged.items()}


class _Send(torch.autograd.Function):
    """Forward: send ``x`` to ``dst``; returns a 0-d token that carries
    the dependency.  Backward: receive x's gradient from ``dst``."""

    @staticmethod
    def forward(ctx, x, dst, tag):
        ctx.meta = (tuple(x.shape), x.dtype, x.device, dst, tag)
        C.send(x.detach(), dst, tag)
        return torch.zeros((), dtype=x.dtype, device=x.device)

    @staticmethod
    def backward(ctx, _):
        shape, dtype, device, dst, tag = ctx.meta
        return C.recv(shape, dtype, device, dst, tag), None, None


class _Recv(torch.autograd.Function):
    """Forward: receive an activation from ``src``.  Backward: send its
    gradient back to ``src``.  ``anchor`` is a tensor that requires a
    gradient, so the node enters the graph."""

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, tag):
        ctx.meta = (src, tag)
        return C.recv(shape, dtype, anchor.device, src, tag)

    @staticmethod
    def backward(ctx, g):
        src, tag = ctx.meta
        C.send(g.contiguous(), src, tag)
        return None, None, None, None, None


class _FromLast(torch.autograd.Function):
    """Forward: the last stage's output on every pipe rank (a broadcast).
    Backward: every rank holds the same output and the same gradient of
    it; the last stage takes it, the others none (their input is a
    placeholder that carries their send tokens)."""

    @staticmethod
    def forward(ctx, y, src, group, is_src):
        ctx.is_src = is_src
        out = y.detach().clone()
        return C.broadcast_(out, src, group)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.is_src else torch.zeros_like(g)), None, None, None


def pipeline_apply(block_fn: Callable[[Dict[str, torch.Tensor], torch.Tensor],
                                      torch.Tensor],
                   stage_params: Dict[str, torch.Tensor], x: torch.Tensor, *,
                   mesh, n_microbatches: int, axis: str = "pipe"
                   ) -> torch.Tensor:
    """Run ``x`` through every stage's layers with GPipe microbatching.

    ``block_fn(one_layer_params, activations) -> activations`` is the
    per-block apply; ``stage_params`` this rank's stage from
    ``shard_stages`` (leaves ``(layers_per_stage, …)``); ``x`` the
    activations ``(batch, …)`` the same on every pipe rank: under data
    parallelism composed with the pipe, this rank's slice of the batch
    (JAX's ``batch_axis``: the slice is taken before the call).  The batch
    must divide into ``n_microbatches``.  Returns activations of ``x``'s
    shape on every pipe rank."""
    S = axis_size(mesh, axis)
    s = axis_index(mesh, axis)
    group = axis_group(mesh, axis)
    M = n_microbatches
    B = x.shape[0]
    if B % M:
        raise ValueError(f"batch {B} not divisible by {M} microbatches")
    mb = B // M
    L = next(iter(stage_params.values())).shape[0]
    layers = [{k: v[i] for k, v in stage_params.items()} for i in range(L)]

    def apply_stage(h):
        for lp in layers:
            h = block_fn(lp, h)
        return h

    if S == 1:
        return torch.cat([apply_stage(x[i * mb:(i + 1) * mb])
                          for i in range(M)])
    pipe_ranks = dist.get_process_group_ranks(group)
    prev = pipe_ranks[s - 1] if s > 0 else None
    nxt = pipe_ranks[s + 1] if s < S - 1 else None
    last = pipe_ranks[S - 1]
    anchor = next(iter(stage_params.values()))
    shape = (mb,) + tuple(x.shape[1:])
    outs, tokens = [], []
    for i in range(M):
        if s == 0:
            h = x[i * mb:(i + 1) * mb]
        else:
            h = _Recv.apply(anchor, shape, x.dtype, prev, i)
        h = apply_stage(h)
        if nxt is not None:
            tokens.append(_Send.apply(h, nxt, i))
        else:
            outs.append(h)
    if nxt is None:
        y = torch.cat(outs)
    else:
        y = torch.zeros_like(x) + torch.stack(tokens).sum()
    return _FromLast.apply(y, last, group, s == S - 1)


def make_pipeline_fn(block_fn, *, mesh, n_microbatches: int,
                     axis: str = "pipe"):
    """Partial of :func:`pipeline_apply`."""

    def f(stage_params, x):
        return pipeline_apply(
            block_fn, stage_params, x, mesh=mesh,
            n_microbatches=n_microbatches, axis=axis)

    return f
