"""SparseLinear — the one linear every tower is built from (port of
``vlm_compression_tpu/models/layers.py``), plus the small shared layers.

Parameters keep the JAX layout and names: ``kernel`` is (in, out), ``bias``
(out,), the optional bool ``mask`` buffer (in, out), True = keep, and with
``lora_rank`` r > 0 the adapters ``lora_a`` (in, r) and ``lora_b`` (r, out)
(the JAX package's ``lora`` collection).  The forward mode is an argument,
as in the JAX package:

  dense        y = x · W                    (teacher path: mask and LoRA
                                             bypassed)
  masked       y = x · (W ⊙ M)              (pruned model; the masked-matmul
                                             kernel on the card)
  sparse_lora  y = x · ((W + s·A·B) ⊙ M)    (the RESSA student; the
                                             sparse-LoRA kernel on the card)
  lora         y = x · (W ⊙ M) + s·(x·A)·B  (ablation: mask on the base only)

with s = lora_alpha / r.  Without a mask the masked modes are x · W, and the
LoRA modes x · W + s·(x·A)·B; a linear with r = 0 runs the LoRA modes as
``masked``.  A and B are cast to the compute dtype, which follows the input.

Compressed leaves, as the JAX package's ``SparseLinear`` reads them:

  * an int8 ``kernel`` (a frozen parameter) with its per-output-column
    ``kernel_scale`` buffer (``ops/quant.quantize_model_int8_``): the dense
    and masked modes run ``int8_matmul`` (the int8 kernel on the card),
    the LoRA modes dequantize once;
  * a bit-packed ``mask`` (int32 words, ``ops/bitmask.pack_masks_``):
    ``masked`` runs ``masked_matmul_packed`` (the packed kernel on the
    card), the LoRA modes unpack once;
  * an int4 ``kernel_q4`` (nibble-packed uint8 (in/2, out), a frozen
    parameter; ``ops/quant.quantize_model_int4_``) with its 2-D
    ``kernel_scale`` (in/g, out), the float ``kernel`` removed: the dense
    and masked modes run ``int4_matmul``, the LoRA modes dequantize once.

The int8 paths run ``select_int8_matmul()``: weight-only by default, W8A8
under the switches of ``ops/quant``.

Sharded (``parallel/mesh.shard_params``): a linear may hold its block of
``kernel`` and ``mask`` (``_shards``), and a Megatron compute plan
(``tp``, set by its tower's ``tensor_parallel_``):

  column-parallel  out-features split: the input enters through
                   ``copy_to`` (its gradient all-reduced), the output is
                   this rank's columns (the bias's too)
  row-parallel     in-features split: a whole input is cut to this rank's
                   features (``scatter_last``), the products' fp32 sums
                   (the kernels' fp32 output) are summed in float32 over
                   the group and rounded once, then the bias

The kernels run unchanged on the local operands.  Where the stored block
is the compute slice (the rule table's own split) the forward reads it as
it is; anywhere else (the fused ViT qkv, whose contiguous halves are not
a rank's heads; FSDP's data-axis blocks) it all-gathers the whole tensor
for the call and indexes the compute slice, and frees it after.  The LoRA
factors stay whole on every rank (no rule names them): a column-parallel
product takes B's matching columns, a row-parallel one A's matching rows,
and their gradients are summed over the ``model`` group
(``tasks/retrain.reduce_lora_grads_``).  int8, int4, W8A8 and packed-mask
linears do not shard (``shard_params`` raises, naming ROADMAP.md).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vlm_compression_tpu_torch.ops.bitmask import (
    infer_pack_group,
    is_packed,
    unpack_mask,
)
from vlm_compression_tpu_torch.ops.masked_linear import (
    lora_matmul_ref,
    masked_matmul,
    masked_matmul_packed,
    sparse_lora_matmul,
)
from vlm_compression_tpu_torch.ops import quant as Q
from vlm_compression_tpu_torch.parallel.collectives import (
    copy_to,
    reduce_from,
    scatter_last,
)

DENSE = "dense"
MASKED = "masked"
SPARSE_LORA = "sparse_lora"
LORA = "lora"
_MODES = (DENSE, MASKED, SPARSE_LORA, LORA)


COL = "col"
ROW = "row"


class TPPlan:
    """A linear's Megatron compute plan: ``kind`` COL or ROW, the model
    group, and ``index`` — the columns (COL) or rows (ROW) of the whole
    kernel this rank computes with, as a LongTensor; ``natural`` when they
    are the rank's contiguous block (the rule table's own split)."""

    def __init__(self, kind: str, group, size: int, rank: int,
                 index: torch.Tensor):
        self.kind, self.group, self.size, self.rank = kind, group, size, rank
        self.index = index
        n = index.numel()
        self.natural = bool(torch.equal(
            index.cpu(), torch.arange(rank * n, (rank + 1) * n)))

    def stored_is_compute(self, spec) -> bool:
        """Whether a tensor stored by ``spec`` holds this plan's slice."""
        want = (None, "model") if self.kind == COL else ("model", None)
        spec = tuple(x[0] if isinstance(x, tuple) and len(x) == 1 else x
                     for x in spec)
        return self.natural and spec == want


def contiguous_plan(kind: str, group, size: int, rank: int,
                    extent: int) -> TPPlan:
    per = extent // size
    return TPPlan(kind, group, size, rank,
                  torch.arange(rank * per, (rank + 1) * per))


def whole(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """``module.<name>`` whole: all-gathered for the call where it is
    stored sharded, as it is otherwise."""
    t = getattr(module, name)
    sh = getattr(module, "_shards", {}).get(name)
    return t if sh is None or t is None else sh.gather(t)


def local_view(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """``module.<name>`` as the module's compute plan reads it: the stored
    block where it is the plan's slice, else the plan's slice of the whole
    (gathered for the call where it is stored sharded)."""
    t = getattr(module, name)
    if t is None:
        return None
    tp = getattr(module, "tp", None)
    sh = getattr(module, "_shards", {}).get(name)
    if sh is not None and tp is not None and tp.stored_is_compute(sh.spec):
        return t
    if sh is not None:
        t = sh.gather(t)
    if tp is None:
        return t
    idx = tp.index.to(t.device)
    return (t[:, idx] if tp.kind == COL else t[idx]).contiguous()


@torch.no_grad()
def assign_whole_(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Write a whole tensor into ``module.<name>``: its stored block where
    it is sharded, all of it otherwise."""
    sh = getattr(module, "_shards", {}).get(name)
    getattr(module, name).copy_(sh.local_of(value) if sh else value)


def clear_tensor_parallel_(model: nn.Module) -> None:
    """Drop every compute plan of ``model`` (whole-model compute again)."""
    for m in model.modules():
        if hasattr(m, "clear_tensor_parallel_"):
            m.clear_tensor_parallel_()
        if isinstance(m, SparseLinear):
            m.tp = None


class SparseLinear(nn.Module):
    shard_aware = True

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 param_dtype: torch.dtype = torch.float32, device=None,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        self.in_features = in_features
        self.features = features
        self.lora_rank = lora_rank
        self.lora_alpha = lora_alpha
        self.kernel = nn.Parameter(torch.empty(
            (in_features, features), dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                              device=device))
                     if use_bias else None)
        self.register_buffer("mask", None)
        self.register_buffer("kernel_scale", None)
        # set by ``set_int4_kernel``, which removes ``kernel``
        self.register_parameter("kernel_q4", None)
        self.tp: Optional[TPPlan] = None
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.zeros(
                (in_features, lora_rank), dtype=param_dtype, device=device))
            self.lora_b = nn.Parameter(torch.zeros(
                (lora_rank, features), dtype=param_dtype, device=device))

    @torch.no_grad()
    def reset_lora_(self, generator: torch.Generator) -> None:
        """The JAX init: A he-uniform (bound sqrt(6 / in)), B zeros, so the
        adapter is a no-op until B trains."""
        bound = math.sqrt(6.0 / self.in_features)
        self.lora_a.uniform_(-bound, bound, generator=generator)
        self.lora_b.zero_()

    def bool_mask(self) -> Optional[torch.Tensor]:
        """The keep-mask as bool (in, out), unpacked if it is packed (as it
        is stored: this rank's block where it is sharded)."""
        if not is_packed(self.mask):
            return self.mask
        return unpack_mask(self.mask, self.in_features,
                           infer_pack_group(self.in_features,
                                            self.mask.shape[0]))

    def forward(self, x: torch.Tensor, mode: str = MASKED) -> torch.Tensor:
        if mode not in _MODES:
            raise ValueError(f"mode {mode!r} not in {_MODES}")
        lora = self.lora_rank > 0 and mode in (SPARSE_LORA, LORA)
        tp = self.tp
        if tp is not None:
            if is_packed(self.mask):
                raise NotImplementedError(
                    "packed masks under tensor parallelism (ROADMAP.md, "
                    "item 10)")
            if tp.kind == COL:
                x = copy_to(x, tp.group)
            elif x.shape[-1] == self.in_features:
                x = scatter_last(x, tp.group)
        # int8 and int4 kernels hold codes, not weights: branch before any
        # cast (an int4 linear has no ``kernel``)
        qscale = q4 = None
        if self.kernel_q4 is not None:
            if lora:
                k = Q.dequantize_weight_int4(self.kernel_q4,
                                             self.kernel_scale, x.dtype)
            else:
                q4 = self.kernel_q4
        elif self.kernel.dtype == torch.int8:
            if lora:
                k = Q.dequantize_weight(self.kernel, self.kernel_scale,
                                        x.dtype)
            else:
                qscale = self.kernel_scale
        else:
            # compute dtype follows the input, as in the JAX package
            k = local_view(self, "kernel").to(x.dtype)
        mask = None if mode == DENSE else local_view(self, "mask")
        # a row-parallel shard's products stay unrounded (fp32) until the
        # sum over ranks
        out = (torch.float32 if tp is not None and tp.kind == ROW
               and x.dtype == torch.bfloat16 else None)
        if qscale is not None:
            y = Q.select_int8_matmul()(x, self.kernel, qscale, mask)
        elif q4 is not None:
            y = Q.int4_matmul(x, q4, self.kernel_scale, mask)
        elif mode == DENSE or (not lora and mask is None):
            y = x @ k if out is None else _matmul_f32(x, k)
        elif not lora:
            if is_packed(mask):
                y = masked_matmul_packed(x, k, mask)
            else:
                y = masked_matmul(x, k, mask, out_dtype=out)
        else:
            s = self.lora_alpha / self.lora_rank
            a, b = self.lora_a, self.lora_b
            if tp is not None:
                idx = tp.index.to(a.device)
                if tp.kind == COL:
                    b = b[:, idx]
                else:
                    a = a[idx]
            a, b = a.to(x.dtype), b.to(x.dtype)
            mask = self.bool_mask() if is_packed(self.mask) \
                else local_view(self, "mask")
            if mask is None:
                z = (x @ a) @ b
                y = ((x @ k if out is None else _matmul_f32(x, k))
                     + (s * z.float()).to(out or x.dtype))
            elif mode == SPARSE_LORA:
                y = sparse_lora_matmul(x, k, mask, a, b, s, out_dtype=out)
            else:
                y = lora_matmul_ref(x, k, mask, a, b, s, out)
        bias = self.bias
        if tp is not None and tp.kind == ROW:
            y = reduce_from(y, tp.group, x.dtype)
        elif tp is not None and bias is not None:
            bias = bias[tp.index.to(bias.device)]
        if bias is not None:
            y = y + bias.to(x.dtype)
        return y


class _MatmulF32(torch.autograd.Function):
    """x @ k with fp32 sums, unrounded: bf16 operands with an fp32 result
    on the card; in fp32 on the CPU, whose matmul has no such variant (the
    same values: bf16 is exact in fp32).  The backward is x @ k's in x's
    dtype (the fp32 output gradient holds bf16 values)."""

    @staticmethod
    def forward(ctx, x, k):
        ctx.save_for_backward(x, k)
        if x.is_cuda:
            y = torch.mm(x.reshape(-1, x.shape[-1]), k,
                         out_dtype=torch.float32)
            return y.reshape(*x.shape[:-1], k.shape[1])
        return x.float() @ k.float()

    @staticmethod
    def backward(ctx, g):
        x, k = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = g @ k.t() if ctx.needs_input_grad[0] else None
        dk = None
        if ctx.needs_input_grad[1]:
            dk = (x.reshape(-1, x.shape[-1]).t().float()
                  @ g.reshape(-1, g.shape[-1]).float()).to(k.dtype)
        return dx, dk


def _matmul_f32(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x @ k (bf16) with fp32 sums, unrounded."""
    return _MatmulF32.apply(x, k)


class LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(dtype=float32)``: fp32 statistics with the fast
    variance E[x²] − E[x]² (clipped at 0); output float32."""

    def __init__(self, features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        mean2 = (x * x).mean(-1, keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


class Embed(nn.Module):
    """Flax ``nn.Embed``: a gather from ``embedding`` (vocab, features).

    Sharded on its rows over ``model`` (the rule ``.*embedding``), the
    lookup is vocab-parallel: each rank gathers the ids it holds, zeros
    the rest, and one all-reduce sums them (exact: one rank contributes
    each row).  Stored any other way (FSDP), the table is gathered whole
    for the call."""

    shard_aware = True

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty((num, features), dtype=dtype,
                                                  device=device))

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        sh = getattr(self, "_shards", {}).get("embedding")
        if sh is None:
            return self.embedding[ids]
        if len(sh.dims) == 1 and sh.dims[0][0] == 0 and \
                sh.spec[0] == "model":
            _, group, _, idx = sh.dims[0]
            rows = self.embedding.shape[0]
            local = ids - idx * rows
            hit = (local >= 0) & (local < rows)
            out = self.embedding[torch.where(hit, local, 0)]
            out = out * hit[..., None].to(out.dtype)
            return reduce_from(out, group)
        return whole(self, "embedding")[ids]

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.lookup(ids)


def gelu(x: torch.Tensor, approximate: bool = False) -> torch.Tensor:
    return nn.functional.gelu(x, approximate="tanh" if approximate else "none")


def run_block(block: nn.Module, *args, remat: bool = False, **kw):
    """One transformer block, under per-block activation checkpointing
    when ``remat`` is set and autograd records (the JAX package's
    ``nn.remat``): its activations are recomputed in the backward, by the
    same calls with the same shapes, so the same kernels and plans."""
    if remat and torch.is_grad_enabled():
        return checkpoint(block, *args, use_reentrant=False, **kw)
    return block(*args, **kw)


def _device(linear: SparseLinear) -> torch.device:
    kern = linear.kernel if linear.kernel is not None else linear.kernel_q4
    return kern.device


def set_mask(linear: SparseLinear, mask: Optional[torch.Tensor]) -> None:
    """Attach (or drop, with None) the keep-mask of one linear: bool
    (in, out), or its packed words (8·⌈in/G⌉, out), G = 128 or 256."""
    shape = (linear.in_features, linear.features)
    if mask is not None and is_packed(mask):
        infer_pack_group(shape[0], mask.shape[0])   # raises on a mismatch
        if mask.shape[1:] != shape[1:]:
            raise ValueError(f"packed mask {tuple(mask.shape)} vs kernel "
                             f"{shape}")
        mask = mask.to(_device(linear)).view(torch.int32)
    elif mask is not None:
        if tuple(mask.shape) != shape:
            raise ValueError(f"mask {tuple(mask.shape)} vs kernel {shape}")
        mask = mask.to(device=_device(linear), dtype=torch.bool)
    # a mask set whole stays whole on a sharded linear
    getattr(linear, "_shards", {}).pop("mask", None)
    linear.mask = mask


def set_int8_kernel(linear: SparseLinear, q: torch.Tensor,
                    scale: torch.Tensor) -> None:
    """Replace the kernel of one linear with int8 codes q (in, out) and
    their fp32 per-column scale (out,).  int8 cannot require a gradient:
    the kernel becomes a frozen parameter, keeping its name."""
    shape = tuple(linear.kernel.shape)
    if q.dtype != torch.int8 or tuple(q.shape) != shape \
            or tuple(scale.shape) != shape[1:]:
        raise ValueError(f"int8 kernel {tuple(q.shape)} {q.dtype} and scale "
                         f"{tuple(scale.shape)} for kernel {shape}")
    dev = linear.kernel.device
    linear.kernel = nn.Parameter(q.to(dev), requires_grad=False)
    linear.kernel_scale = scale.to(device=dev, dtype=torch.float32)


def set_int4_kernel(linear: SparseLinear, packed: torch.Tensor,
                    scale: torch.Tensor) -> None:
    """Replace the kernel of one linear with int4 codes, nibble-packed
    (in/2, out) uint8, and their fp32 group scales (in/g, out): they become
    the frozen parameter ``kernel_q4`` and the ``kernel_scale`` buffer,
    and the float ``kernel`` is removed."""
    k, n = linear.in_features, linear.features
    if packed.dtype != torch.uint8 or tuple(packed.shape) != (k // 2, n) \
            or scale.ndim != 2 or scale.shape[1] != n \
            or scale.shape[0] == 0 or k % scale.shape[0]:
        raise ValueError(f"int4 kernel {tuple(packed.shape)} {packed.dtype} "
                         f"and scale {tuple(scale.shape)} for kernel "
                         f"{(k, n)}")
    dev = _device(linear)
    linear.kernel = None
    linear.kernel_q4 = nn.Parameter(packed.to(dev), requires_grad=False)
    linear.kernel_scale = scale.to(device=dev, dtype=torch.float32)


def lora_linears(model: nn.Module):
    """(name, SparseLinear) for every linear of ``model`` with adapters."""
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, SparseLinear) and m.lora_rank > 0]


def init_lora_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Reset every adapter of ``model`` (A he-uniform, B zeros) from one
    generator of its own, in name order."""
    gen = None
    for _, m in sorted(lora_linears(model), key=lambda nm: nm[0]):
        if gen is None:
            gen = torch.Generator(device=m.lora_a.device).manual_seed(seed)
        m.reset_lora_(gen)
    return model
