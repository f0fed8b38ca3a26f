"""Attention core shared by every tower: plain versions + flash kernels.

Counterpart of ``vlm_compression_tpu/ops/attention.py``.  Semantics,
identical in every version:

  s   = (q · kᵀ) * scale + Σ bias_i          (fp32)
  s   = NEG_INF where right-aligned causal masking hides key j from query i
        (j > i + m − n)
  p   = softmax(s, axis=-1)                   (fp32)
  out = p.astype(v.dtype) · v

and the flash backward of the JAX package's kernels, from the saved
log-sum-exp:

  p  = exp(s − lse);  delta = rowsum(g ⊙ out);  u = p ⊙ (g·vᵀ − delta)
  dv = pᵀ·g;  ds = u · scale;  dq = ds·k;  dk = dsᵀ·q
  dbias_i = u, summed over bias i's broadcast axes (fp32)

where entries the causal flag hides get ds = 0 (it is a ``where`` in the
reference, so they carry no gradient — rows that see no key included).

Layout: q (b, n, h, d), k/v (b, m, h, d); biases are additive fp32 arrays
broadcastable to (b, h, n, m).  ``attention_core`` is an autograd Function
whose forward runs ``mha_reference`` on CPU tensors and, on CUDA tensors,
the forward route ``plan_forward`` picks — the bf16 TMA + wgmma kernel of
``csrc/flash_attention_fwd_wgmma.cu``, or the kernels of
``csrc/flash_attention.cu`` (bf16 on mma.sync where the first does not
take the call, fp32 on the CUDA cores) — and whose backward runs
``flash_attention_backward_ref`` (with ``flash_attention_dbias_ref`` for
the biases) on the CPU and, on the card, one call of
``flash_attention_backward`` for q, k, v and every bias that needs a
gradient, on the route ``plan`` picks — the bf16 TMA + wgmma kernel of
``csrc/flash_attention_bwd_wgmma.cu`` (with its delta pre-pass and dq
cast; dq summed over the kv tiles in a fixed order), which also returns
the gradient of each bias that keeps the query and key dims, or the dq and
dk/dv kernels of ``csrc/flash_attention_bwd.cu`` (fp32, and bf16 the first
does not take) — and, for every other bias gradient (``plan_dbias``: fp32,
the mma.sync route, a bias without a query or key dim), the dbias kernel
of that file: launch or raise, no fallback.
``launches`` (every forward), ``fwd_wgmma_launches`` (the forward's TMA +
wgmma route), ``bwd_wgmma_launches``, ``dq_launches``, ``dkv_launches``,
``dbias_launches`` and ``delta_launches`` (the pre-pass alone, for the
other two) count kernel launches; ``bwd_dbias_outputs`` the bias gradients
the TMA + wgmma backward returned; ``shape_launches`` the forward's by
shape and route, ``bwd_shape_launches`` the backward's (one a call that
launched a kernel of either route).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from vlm_compression_tpu_torch.ops import _cuda

NEG_INF = -1e9  # matches the towers' additive-mask constant

launches = 0
fwd_wgmma_launches = 0
bwd_wgmma_launches = 0
dq_launches = 0
dkv_launches = 0
dbias_launches = 0
delta_launches = 0
bwd_dbias_outputs = 0
# (b, n, m, h, d, route) -> forward launches
shape_launches: dict = {}
# (b, n, m, h, d, route) -> backward calls that launched a kernel
bwd_shape_launches: dict = {}


def _as_4d(bias: torch.Tensor) -> torch.Tensor:
    return bias.reshape((1,) * (4 - bias.ndim) + tuple(bias.shape)) \
        if bias.ndim < 4 else bias


def _hidden(n: int, m: int, device) -> torch.Tensor:
    """(n, m) bool: True where right-aligned causal masking hides key j
    from query i."""
    return (torch.arange(m, device=device)[None, :]
            > torch.arange(n, device=device)[:, None] + (m - n))


def _scores(q, k, biases, scale, causal):
    """fp32 scores (b, h, n, m) with biases and causal masking."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    for bias in biases:
        s = s + bias.float()
    if causal:
        s = torch.where(_hidden(s.shape[-2], s.shape[-1], s.device)[None, None],
                        torch.full((), NEG_INF, dtype=s.dtype, device=s.device),
                        s)
    return s


def mha_reference(q, k, v, biases: Sequence[torch.Tensor] = (),
                  scale: float = 1.0, causal: bool = False) -> torch.Tensor:
    """q (b,n,h,d), k/v (b,m,h,d), biases broadcastable to (b,h,n,m)."""
    p = torch.softmax(_scores(q, k, biases, scale, causal), dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p.to(v.dtype), v)


def flash_attention_backward_ref(q, k, v, out, lse, g,
                                 biases: Sequence[torch.Tensor] = (),
                                 scale: float = 1.0, causal: bool = False,
                                 dbias_of: Sequence[int] = ()):
    """Plain version of the backward kernels: (dq, dk, dv, *dbias) from the
    saved out and lse (b, h, n), recomputing p = exp(s − lse) as they do
    (an entry the causal flag hides takes its exact p, 1/m in a row that
    sees no key and 0 elsewhere, and ds = 0).  ds is cast to k's (q's)
    dtype before ds·k (dsᵀ·q), p to g's dtype before pᵀ·g, as in the JAX
    kernels; products accumulate in fp32.  After dq, dk, dv comes
    ``flash_attention_dbias_ref``'s gradient of each bias in ``dbias_of``,
    in that order."""
    s = _scores(q, k, biases, scale, causal)
    p = torch.exp(s - lse[..., None])
    delta = torch.einsum("bnhd,bnhd->bhn", g.float(), out.float())
    dp = torch.einsum("bnhd,bmhd->bhnm", g.float(), v.float())
    ds = p * (dp - delta[..., None]) * scale
    if causal:
        n, m = s.shape[-2], s.shape[-1]
        hid = _hidden(n, m, s.device)
        # exact p of a hidden entry: 1/m in a row that sees no key (its
        # lse, −1e9 + log m, rounds to −1e9 in fp32), else 0
        blind = (torch.arange(n, device=s.device) + (m - n) < 0)[:, None]
        p = torch.where(hid, torch.where(blind, 1.0 / m, 0.0), p)
        ds = torch.where(hid, 0.0, ds)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhnm,bnhd->bmhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhnm,bnhd->bmhd", p.to(g.dtype).float(), g.float())
    dbs = [flash_attention_dbias_ref(q, k, v, out, lse, g, biases, i, scale,
                                     causal) for i in dbias_of]
    return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), *dbs)


def flash_attention_dbias_ref(q, k, v, out, lse, g,
                              biases: Sequence[torch.Tensor], i: int,
                              scale: float = 1.0, causal: bool = False):
    """Plain version of the dbias kernel: the gradient of bias ``i``, fp32
    at its (4-d) shape — ds = p ⊙ (g·vᵀ − delta), unscaled, with p
    recomputed from the saved lse as ``flash_attention_backward_ref`` does,
    0 where the causal flag hides the entry, and summed over every axis the
    bias broadcasts."""
    s = _scores(q, k, biases, scale, causal)
    p = torch.exp(s - lse[..., None])
    delta = torch.einsum("bnhd,bnhd->bhn", g.float(), out.float())
    dp = torch.einsum("bnhd,bmhd->bhnm", g.float(), v.float())
    ds = p * (dp - delta[..., None])
    if causal:
        ds = torch.where(_hidden(s.shape[-2], s.shape[-1], s.device), 0.0, ds)
    shape = _as_4d(biases[i]).shape
    axes = [ax for ax in range(4) if shape[ax] == 1 and ds.shape[ax] > 1]
    return (ds.sum(axes, keepdim=True) if axes else ds).reshape(shape)


class _FlashAttention(torch.autograd.Function):
    """Forward saves q, k, v, out, lse and the biases at their broadcast
    shapes; backward makes one backward call (the plain version on the
    CPU) for the gradients of q, k, v and of every bias that needs one."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, *biases):
        if q.device.type == "cpu":
            s = _scores(q, k, biases, scale, causal)
            out = torch.einsum("bhnm,bmhd->bnhd",
                               torch.softmax(s, -1).to(v.dtype), v)
            lse = torch.logsumexp(s, -1)
        else:
            out, lse = flash_attention(q, k, v, biases, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse, *biases)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse, *biases = ctx.saved_tensors
        need = ctx.needs_input_grad
        args = (q, k, v, out, lse, g, biases, ctx.scale, ctx.causal)
        want = [i for i in range(len(biases)) if need[5 + i]]
        if q.device.type == "cpu":
            dq, dk, dv, *got = flash_attention_backward_ref(
                *args, dbias_of=want)
        else:
            dq, dk, dv, *got = flash_attention_backward(
                *args, need_dq=need[0], need_dkv=need[1] or need[2],
                dbias_of=want)
        dbs = [None] * len(biases)
        for i, db in zip(want, got):
            dbs[i] = db
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None, *dbs)


def attention_core(q, k, v, biases: Sequence[Optional[torch.Tensor]] = (),
                   scale: float = 1.0, causal: bool = False) -> torch.Tensor:
    """Shared attention core for every tower (None biases are dropped)."""
    biases = [_as_4d(x) for x in biases if x is not None]
    if not torch.is_grad_enabled() or not any(
            t.requires_grad for t in (q, k, v, *biases)):
        if q.device.type == "cpu":
            return mha_reference(q, k, v, biases, scale, causal)
        return flash_attention(q, k, v, biases, scale, causal)[0]
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal), *biases)


_DTYPES = (torch.bfloat16, torch.float32)
_STRIDES = ctypes.c_longlong * 17


class _BiasShard(torch.autograd.Function):
    """Forward: this rank's block of a global bias (its batch and head
    dims cut where the bias does not broadcast on them).  Backward: the
    global bias's gradient on every rank — the cut dims all-gathered over
    their groups, the broadcast dims summed over theirs."""

    @staticmethod
    def forward(ctx, bias, cuts, sums):
        from vlm_compression_tpu_torch.parallel.collectives import chunk

        ctx.cuts, ctx.sums = cuts, sums
        for dim, group in cuts:
            bias = chunk(bias, group, dim)
        return bias.contiguous()

    @staticmethod
    def backward(ctx, g):
        from vlm_compression_tpu_torch.parallel.collectives import (
            all_gather_dim,
            all_reduce_,
        )

        g = g.contiguous().clone()
        for group in ctx.sums:
            all_reduce_(g, group)
        for dim, group in ctx.cuts:
            g = all_gather_dim(g, group, dim)
        return g, None, None


def sharded_attention_core(q, k, v, biases: Sequence[Optional[torch.Tensor]]
                           = (), scale: float = 1.0, causal: bool = False, *,
                           mesh) -> torch.Tensor:
    """``attention_core`` on this rank's (batch shard, head shard) of q, k
    and v — the port's counterpart of the JAX package's
    ``_partitioned_fwd`` / ``_partitioned_bwd`` (``ops/attention.py``): the
    kernels run per shard, unchanged.  ``biases`` are global (b | 1,
    h | 1, n, m): each is cut to the rank's block on the dims it does not
    broadcast on, and its gradient is the global one on every rank —
    all-gathered over the cut dims' groups and summed over the groups of
    the axes it broadcasts on (T5's (1, h, n, m) position bias over
    ``data``, a (b, 1, 1, m) pad bias over ``model``).  The batch is split
    over the mesh's ``data`` axis, the heads over its ``model`` axis."""
    from vlm_compression_tpu_torch.parallel.mesh import axis_group

    groups = (axis_group(mesh, "data"), axis_group(mesh, "model"))
    local = []
    for x in biases:
        if x is None:
            continue
        x = _as_4d(x)
        cuts, sums = [], []
        for dim, group in zip((0, 1), groups):
            if group is None:
                continue
            if x.shape[dim] == 1:
                sums.append(group)
            else:
                cuts.append((dim, group))
        local.append(_BiasShard.apply(x, tuple(cuts), tuple(sums))
                     if cuts or sums else x)
    return attention_core(q, k, v, local, scale=scale, causal=causal)


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` lies where the kernels run (a CUDA device)."""
    return t.device.type == "cuda"


def _check_inputs(q, k, v, biases):
    """Raise the specific error for q/k/v the kernel does not take."""
    if not _on_card(q):
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape != (b, m, h, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError("flash_attention: q, k, v must all be bfloat16 or "
                        "all float32")
    if not 0 < d <= 128:
        raise ValueError(f"flash_attention: head dim {d} not in 1..128")
    if m == 0:
        raise ValueError("flash_attention: no keys")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: all inputs must share a device")
    if len(biases) > 2:
        raise ValueError("flash_attention: at most two additive biases")
    raise ValueError("flash_attention: q/k/v need a contiguous last dim")


def _check_bias(bias, device, full):
    if bias.dtype != torch.float32:
        raise TypeError(f"flash_attention: biases must be float32, got "
                        f"{bias.dtype}")
    if bias.device != device:
        raise ValueError("flash_attention: all inputs must share a device")
    raise ValueError(f"flash_attention: bias {tuple(bias.shape)} does not "
                     f"broadcast to {full}")


def _layout(q, k, v, biases):
    """Validate q/k/v and the biases for the kernels → (17 strides: q, k, v
    (b, seq, h); bias0, bias1 (b, h, n, m), 0 on broadcast axes — the
    kernels read the small arrays, never expanded; the two bias pointers;
    whether 16-byte row loads are safe)."""
    dev = q.device
    b, n, h, d = q.shape
    m = k.shape[1]
    if not (_on_card(q) and k.shape == (b, m, h, d)
            and v.shape == k.shape and q.dtype == k.dtype == v.dtype
            and q.dtype in _DTYPES and 0 < d <= 128 and m > 0
            and k.device == dev and v.device == dev and q.stride(3) == 1
            and k.stride(3) == 1 and v.stride(3) == 1 and len(biases) <= 2):
        _check_inputs(q, k, v, biases)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3]]
    ptrs = [None, None]
    full = (b, h, n, m)
    for i, bias in enumerate(biases):
        bias = _as_4d(bias)
        shape = bias.shape
        if not (bias.dtype == torch.float32 and bias.device == dev
                and all(s in (1, f) for s, f in zip(shape, full))):
            _check_bias(bias, dev, full)
        st = bias.stride()
        strides += [st[ax] if shape[ax] > 1 else 0 for ax in range(4)]
        ptrs[i] = bias.data_ptr()
    strides += [0] * (17 - len(strides))
    # 16-byte row loads need d, every q/k/v stride and base 8-aligned
    vec = (d % 8 == 0 and all(x % 8 == 0 for x in strides[:9])
           and q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0
           and v.data_ptr() % 16 == 0)
    return strides, ptrs, vec


# the routes of the forward (``plan_forward``) and of the backward (``plan``)
WGMMA = "wgmma"   # bf16, TMA + wgmma: csrc/flash_attention_fwd_wgmma.cu,
#                   csrc/flash_attention_bwd_wgmma.cu
MMA = "mma"       # bf16 on mma.sync: csrc/flash_attention.cu,
#                   csrc/flash_attention_bwd.cu
FP32 = "fp32"     # fp32 on the CUDA cores, the same two sources


def _tma_aligned(*tensors) -> bool:
    """16-byte aligned bases and (batch, seq, head) strides: what the TMA
    maps and the 16-byte row loads need."""
    return all(t.data_ptr() % 16 == 0
               and all((x * t.element_size()) % 16 == 0
                       for x in t.stride()[:3]) for t in tensors)


def _wgmma_head(d: int) -> bool:
    """A head dim the TMA + wgmma kernels hold: 32 < d ≤ 128, d % 8 == 0
    (a 16-byte TMA row stride; padded to ``_head_pad(d)`` columns)."""
    return d % 8 == 0 and 32 < d <= 128


def _head_pad(d: int) -> int:
    """The head-dim width DP the TMA + wgmma kernels compute at (and the
    backward's dq slabs are laid out at): 64, 96 or 128, TMA's zero fill
    padding d to it."""
    return 64 if d <= 64 else 96 if d <= 96 else 128


def plan_forward(n: int, m: int, d: int, *, bf16: bool = True,
                 aligned: bool = True) -> str:
    """The forward's route for one call, from the dtype, head dim,
    alignment and shape alone (a miss is a routed decision, never a launch
    that is retried):

    - float32: the CUDA-core kernel (FP32);
    - bf16 that TMA can take (``aligned``: 16-byte aligned q, k and v bases
      and (batch, seq, head) strides) with a head dim the TMA + wgmma
      kernel holds (32 < d ≤ 128, d % 8 == 0): WGMMA;
    - any other bf16: the mma.sync kernel (MMA).

    No shape rule: at every shape of chip_smoke.py's ``FLASH_SHAPES``, the
    decode steps (n = 1) included, the TMA + wgmma route was the faster in
    one call of ``scripts/torch_fwd_check.py`` (H100 80GB HBM3, 700.00 W;
    ms, the mean of two turns, TMA + wgmma vs mma.sync):

        vit_self_calib          0.2719 vs 1.4561
        vit_self_b16            0.0442 vs 0.2268
        qformer_cross           0.0168 vs 0.0598
        qformer_self            0.0142 vs 0.0270
        t5_encoder_calib        0.1318 vs 0.4809
        t5_encoder_b16          0.0239 vs 0.0727
        t5_decoder_self_calib   0.0411 vs 0.1060
        t5_self_decode          0.0128 vs 0.0219
        t5_cross_decode         0.0179 vs 0.0431

    and at every shape of its ``VICUNA_FLASH_SHAPES`` (LLaMA's d = 128,
    DP = 128; one call of ``scripts/torch_fwd_check.py --d 128``, the same
    card and limit, ms, the mean of two turns):

        llama_self_calib        0.1919 vs 0.9146
        llama_prime_gen         0.0479 vs 0.1821
        llama_decode_gen        0.0285 vs 0.0893
        llama_prime_vqa         0.2355 vs 1.0729
        llama_beam_step         0.1672 vs 0.7169
        llama_self_train        0.0569 vs 0.2446

    (PERF.md §6)."""
    if not bf16:
        return FP32
    if aligned and _wgmma_head(d):
        return WGMMA
    return MMA


def _fwd_wgs(n: int, biased: bool, d: int) -> int:
    """Consumer warpgroups a block of the TMA + wgmma forward (64 query
    rows each; two blocks an SM with one, one with three).  Three above
    n = 128 with no bias: vit_self_calib (n = 257) 0.2719 ms against 0.3997
    with one, in the call of ``scripts/torch_fwd_check.py`` that
    ``plan_forward``'s table comes from.  One elsewhere: three hold 160
    registers each, which the bias paths spilled, and at n ≤ 128 the
    second and third hold few rows or none (with the bias paths built for
    three, an earlier call read t5_encoder_calib, n = 72, at 0.1378 with
    three against 0.1301 with one; PERF.md §6).  One at d > 96 always:
    three warpgroups' Q and O tiles at DP = 128 and the kv ring do not fit
    a block's shared memory (the kernel refuses them)."""
    return 3 if n > 128 and not biased and d <= 96 else 1


def flash_attention(q, k, v, biases: Sequence[torch.Tensor] = (),
                    scale: float = 1.0, causal: bool = False,
                    _impl: Optional[str] = None):
    """Launch the forward on CUDA tensors → (out (b,n,h,d) in q's dtype,
    lse (b,h,n) float32).  The route is ``plan_forward``'s; ``_impl``
    (internal: the timing phase of chip_smoke.py) forces WGMMA or MMA, and
    raises where that route cannot take the call."""
    global launches, fwd_wgmma_launches
    strides, ptrs, vec = _layout(q, k, v, biases)
    dev = q.device
    b, n, h, d = q.shape
    m = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    route = plan_forward(n, m, d, bf16=bf16, aligned=_tma_aligned(q, k, v))
    if _impl is not None:
        if _impl not in (WGMMA, MMA) or not bf16 or \
                (_impl == WGMMA and route != WGMMA):
            raise ValueError(f"flash_attention: route {_impl!r} cannot take "
                             f"this call (plan_forward: {route})")
        route = _impl
    out = torch.empty((b, n, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=dev)
    if b * n * h == 0:
        return out, lse
    if route == WGMMA:
        err = _cuda.library("flash_attention_fwd_wgmma") \
            .flash_attention_fwd_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), ptrs[0], ptrs[1], _STRIDES(*strides), b, n,
                m, h, d, float(scale), int(bool(causal)),
                _fwd_wgs(n, bool(biases), d),
                _cuda.stream_ptr(dev))
        _cuda.check(err, "flash_attention_fwd_wgmma")
        fwd_wgmma_launches += 1
    else:
        err = _cuda.library("flash_attention").flash_attention_fwd(
            int(bf16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), lse.data_ptr(), ptrs[0], ptrs[1],
            _STRIDES(*strides), b, n, m, h, d, float(scale),
            int(bool(causal)), int(vec), _cuda.stream_ptr(dev))
        _cuda.check(err, "flash_attention")
    launches += 1
    key = (b, n, m, h, d, route)
    shape_launches[key] = shape_launches.get(key, 0) + 1
    return out, lse


_BWD_STRIDES = ctypes.c_longlong * 20
_WGMMA_STRIDES = ctypes.c_longlong * 23


def plan(n: int, m: int, d: int, *, bf16: bool = True,
         aligned: bool = True) -> str:
    """The backward's route for one call, from the dtype, head dim,
    alignment and shape alone (a miss is a routed decision, never a launch
    that is retried):

    - float32: the CUDA-core kernels (FP32);
    - bf16 that TMA can take (``aligned``: 16-byte aligned q, k, v, g and
      out bases and (batch, seq, head) strides) with a head dim the TMA +
      wgmma kernel holds (32 < d ≤ 128, d % 8 == 0): WGMMA;
    - any other bf16: the mma.sync kernels (MMA).

    No shape rule: at every training shape of chip_smoke.py's
    ``BWD_SHAPES`` the TMA + wgmma route was the faster in one call of its
    timing phase (H100 80GB HBM3, 700.00 W; whole backward, ms, TMA +
    wgmma vs mma.sync): vit_self 0.3118 vs 1.1642, qformer_cross 0.0723
    vs 0.1904, qformer_self 0.0521 vs 0.1286, t5_encoder 0.1267 vs
    0.3440, t5_decoder_self 0.0439 vs 0.0661, t5_decoder_cross 0.0704 vs
    0.1568; and at LLaMA's d = 128, llama_self (b 32, n = m = 72, its
    causal + pad bias) 0.2216 vs 0.5498, in one call of
    ``scripts/torch_bwd_check.py --d 128`` (the same card and limit; the
    TMA + wgmma time the mean of two turns) (PERF.md §6)."""
    if not bf16:
        return FP32
    if aligned and _wgmma_head(d):
        return WGMMA
    return MMA


# where a bias's gradient comes from (``plan_dbias``)
FUSED = "fused"   # an output of the TMA + wgmma backward
DBIAS = "dbias"   # the dbias kernel of csrc/flash_attention_bwd.cu


def plan_dbias(route: str, shape: Sequence[int], n: int, m: int) -> str:
    """Where the gradient of a bias of 4-d ``shape`` comes from in a
    backward on ``route`` (``plan``'s), from the route and the shape alone
    (a routed decision, never a launch that is retried):

    - the TMA + wgmma route and a bias that keeps the query and key dims,
      (1 | b, 1 | h, n, m): FUSED, an output of that route's kernel (its
      uᵀ tiles stored, or summed over batch and heads in a fixed order by
      a small pass), no recompute of S or dP;
    - every other call — fp32, the mma.sync route, a bias without a query
      or key dim ((b, 1, 1, m), a key dim of 1): DBIAS, the dbias kernel.
    """
    return FUSED if route == WGMMA and shape[2] == n and shape[3] == m \
        else DBIAS


def _backward_layout(q, k, v, out, lse, g, biases, what):
    """_layout plus g's strides; g and out with a contiguous last dim and
    the contiguous lse.  (delta = rowsum(g ⊙ out) is formed on the card by
    the pre-pass, ``_delta``.)"""
    strides, ptrs, vec = _layout(q, k, v, biases)
    b, n, h, _ = q.shape
    if g.shape != q.shape or g.dtype != q.dtype or g.device != q.device or \
            out.shape != q.shape or out.dtype != q.dtype or \
            lse.shape != (b, h, n) or lse.dtype != torch.float32:
        raise ValueError(f"{what}: g {tuple(g.shape)} {g.dtype}, out "
                         f"{tuple(out.shape)}, lse {tuple(lse.shape)} "
                         f"{lse.dtype} for q {tuple(q.shape)} {q.dtype}")
    g = g if g.stride(3) == 1 else g.contiguous()
    out = out if out.stride(3) == 1 else out.contiguous()
    lse = lse.contiguous()
    strides = strides + list(g.stride()[:3])
    vec = int(vec and all(x % 8 == 0 for x in strides[17:])
              and g.data_ptr() % 16 == 0)
    return strides, ptrs, vec, g, out, lse


def _delta(g, out):
    """delta = rowsum(g ⊙ out), (b, h, n) fp32, by the pre-pass kernel."""
    global delta_launches
    b, n, h, d = g.shape
    delta = torch.empty((b, h, n), dtype=torch.float32, device=g.device)
    vec = int(d % 8 == 0 and _tma_aligned(g, out))
    err = _cuda.library("flash_attention_bwd_wgmma").flash_attention_bwd_delta(
        int(g.dtype == torch.bfloat16), g.data_ptr(), out.data_ptr(),
        delta.data_ptr(), (ctypes.c_longlong * 6)(*g.stride()[:3],
                                                  *out.stride()[:3]),
        b, n, h, d, vec, _cuda.stream_ptr(g.device))
    _cuda.check(err, "flash_attention_bwd_delta")
    delta_launches += 1
    return delta


def flash_attention_backward(q, k, v, out, lse, g,
                             biases: Sequence[torch.Tensor] = (),
                             scale: float = 1.0, causal: bool = False,
                             need_dq: bool = True, need_dkv: bool = True,
                             dbias_of: Sequence[int] = (),
                             _impl: Optional[str] = None):
    """Launch the backward on CUDA tensors → (dq, dk, dv, *dbias): dq, dk,
    dv in the layouts and dtypes of q, k, v (None for a gradient not asked
    for), then the gradient of each bias in ``dbias_of``, float32 at its
    4-d shape — an output of the same TMA + wgmma launch where
    ``plan_dbias`` says FUSED, else the dbias kernel's
    (``flash_attention_dbias``).  ``lse`` is the forward's (b, h, n)
    float32 log-sum-exp.  The route is ``plan``'s; ``_impl`` (internal:
    the timing phase of chip_smoke.py) forces WGMMA or MMA, and raises
    where that route cannot take the call."""
    global bwd_wgmma_launches, dq_launches, dkv_launches, bwd_dbias_outputs
    strides, ptrs, vec, g, out, lse = _backward_layout(
        q, k, v, out, lse, g, biases, "flash_attention_backward")
    dev = q.device
    b, n, h, d = q.shape
    m = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    route = plan(n, m, d, bf16=bf16,
                 aligned=_tma_aligned(q, k, v, g, out))
    if _impl is not None:
        if _impl not in (WGMMA, MMA) or not bf16 or \
                (_impl == WGMMA and route != WGMMA):
            raise ValueError(f"flash_attention_backward: route {_impl!r} "
                             f"cannot take this call (plan: {route})")
        route = _impl
    dbias_of = tuple(dbias_of)
    if len(set(dbias_of)) != len(dbias_of) or \
            not all(0 <= i < len(biases) for i in dbias_of):
        raise ValueError(f"flash_attention_backward: dbias_of {dbias_of} "
                         f"for {len(biases)} biases")
    shapes = {i: tuple(_as_4d(biases[i]).shape) for i in dbias_of}
    fused = [i for i in dbias_of
             if plan_dbias(route, shapes[i], n, m) == FUSED]
    dq = torch.empty((b, n, h, d), dtype=q.dtype, device=dev) \
        if need_dq else None
    dk, dv = (torch.empty((b, m, h, d), dtype=k.dtype, device=dev),
              torch.empty((b, m, h, d), dtype=v.dtype, device=dev)) \
        if need_dkv else (None, None)
    if b * n * h == 0:
        return (dq if dq is None else dq.zero_(),
                dk if dk is None else dk.zero_(),
                dv if dv is None else dv.zero_(),
                *(torch.zeros(shapes[i], dtype=torch.float32, device=dev)
                  for i in dbias_of))
    dbias = {i: torch.empty(shapes[i], dtype=torch.float32, device=dev)
             for i in fused}
    if route == WGMMA and (need_dq or need_dkv or fused):
        n_pad, d_pad = -(-n // 64) * 64, _head_pad(d)
        pads = torch.empty((2, b, h, n_pad), dtype=torch.float32, device=dev)
        # dq: an fp32 slab a kv tile, which the cast sums in kv order
        ws = torch.empty((-(-m // 64), b, h, n_pad, d_pad),
                         dtype=torch.float32, device=dev) \
            if need_dq else None
        # bits 2i and 2i + 1: fused bias i keeps the batch, the head; one
        # that broadcasts over either (b or h above 1) takes a (b, h, n, m)
        # scratch of the (batch, head) tiles, which a pass sums in order
        keeps = {i: (shapes[i][0] == b, shapes[i][1] == h) for i in fused}
        keep = sum((kb | kh << 1) << 2 * i for i, (kb, kh) in keeps.items())
        sums = {i: torch.empty((b, h, n, m), dtype=torch.float32, device=dev)
                for i, (kb, kh) in keeps.items()
                if (1 if kb else b) * (1 if kh else h) > 1}
        ptr = (lambda t: None if t is None else t.data_ptr())
        err = _cuda.library("flash_attention_bwd_wgmma") \
            .flash_attention_bwd_wgmma(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                out.data_ptr(), lse.data_ptr(), pads[0].data_ptr(),
                pads[1].data_ptr(), ptr(ws), ptr(dq), ptr(dk), ptr(dv),
                ptrs[0], ptrs[1],
                _WGMMA_STRIDES(*strides, *out.stride()[:3]), b, n, m, h, d,
                float(scale), int(bool(causal)), ptr(dbias.get(0)),
                ptr(dbias.get(1)), ptr(sums.get(0)), ptr(sums.get(1)), keep,
                _cuda.stream_ptr(dev))
        _cuda.check(err, "flash_attention_bwd_wgmma")
        bwd_wgmma_launches += 1
        bwd_dbias_outputs += len(fused)
    elif route != WGMMA and (need_dq or need_dkv):
        delta = _delta(g, out)
        lib = _cuda.library("flash_attention_bwd")
        common = (int(bf16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                  g.data_ptr(), lse.data_ptr(), delta.data_ptr())
        tail = (ptrs[0], ptrs[1], _BWD_STRIDES(*strides), b, n, m, h, d,
                float(scale), int(bool(causal)), vec, _cuda.stream_ptr(dev))
        if need_dq:
            _cuda.check(lib.flash_attention_bwd_dq(*common, dq.data_ptr(),
                                                   *tail),
                        "flash_attention_bwd_dq")
            dq_launches += 1
        if need_dkv:
            _cuda.check(lib.flash_attention_bwd_dkv(*common, dk.data_ptr(),
                                                    dv.data_ptr(), *tail),
                        "flash_attention_bwd_dkv")
            dkv_launches += 1
    if need_dq or need_dkv or (route == WGMMA and fused):
        key = (b, n, m, h, d, route)
        bwd_shape_launches[key] = bwd_shape_launches.get(key, 0) + 1
    for i in dbias_of:
        if i not in dbias:
            dbias[i] = flash_attention_dbias(q, k, v, out, lse, g, biases, i,
                                             scale, causal)
    return (dq, dk, dv, *(dbias[i] for i in dbias_of))


def flash_attention_dbias(q, k, v, out, lse, g,
                          biases: Sequence[torch.Tensor], i: int,
                          scale: float = 1.0, causal: bool = False):
    """Launch the dbias kernel on CUDA tensors → the gradient of bias
    ``i``, float32 at its 4-d shape (every axis where it is 1 summed)."""
    global dbias_launches
    strides, ptrs, vec, g, out, lse = _backward_layout(
        q, k, v, out, lse, g, biases, "flash_attention_dbias")
    b, n, h, _ = q.shape
    m = k.shape[1]
    shape = tuple(_as_4d(biases[i]).shape)
    # the axes the bias keeps, as the kernel's bits b 1, h 2, n 4, m 8
    keep = sum(1 << ax for ax, (s, f) in enumerate(zip(shape, (b, h, n, m)))
               if s == f and f > 1)
    db = torch.zeros(shape, dtype=torch.float32, device=q.device)
    if b * n * h == 0:
        return db
    delta = _delta(g, out)
    err = _cuda.library("flash_attention_bwd").flash_attention_bwd_dbias(
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        db.data_ptr(), keep, ptrs[0], ptrs[1], _BWD_STRIDES(*strides), b, n,
        m, h, q.shape[3], float(scale), int(bool(causal)), vec,
        _cuda.stream_ptr(q.device))
    _cuda.check(err, "flash_attention_bwd_dbias")
    dbias_launches += 1
    return db
