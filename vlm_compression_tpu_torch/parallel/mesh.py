"""Device mesh + sharding rules (port of
``vlm_compression_tpu/parallel/mesh.py``).

The JAX package places every array with a ``NamedSharding`` and lets GSPMD
insert the collectives.  The port runs one process per device (as
``torchrun`` starts it) over a ``torch.distributed`` process group, and its
mesh is a ``DeviceMesh`` with the JAX axis names in JAX's order

    replica, pipe, data, model

(``replica`` only where ``dcn_data > 1``, ``pipe`` only where ``pipe > 1``;
``replica`` is an outer data axis).  The rule tables, ``mask_rules``,
``param_partition_spec`` and ``_spec_fits`` are the JAX package's, with
specs as plain tuples of axis names (an entry per dim: None, a name, or a
tuple of names); the port keeps the JAX leaf names, so a regex reads the
port's dotted name with ``.`` as ``/``.

``shard_params`` replaces each matched parameter or mask buffer of a
module with this rank's block of it, in place, and records its global shape
and spec on the owning module (``_shards``); the towers' modules read
their sharded tensors through ``layers.local_view`` / ``layers.whole``.
Where the mesh's ``model`` axis has more than one rank it also gives the
towers their Megatron compute plans (``tensor_parallel_``): column- and
row-parallel linears over local heads, explicit collectives
(``parallel/collectives.py``).  ``gather_params`` undoes both.
"""

from __future__ import annotations

import dataclasses
import itertools
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

Spec = Tuple
AXES = ("replica", "pipe", "data", "model")


@dataclasses.dataclass
class MeshConfig:
    data: int = -1  # -1 = all remaining ranks
    model: int = 1
    # pipeline stages (parallel/pipeline.py); 1 = no pipe axis
    pipe: int = 1
    # an outer replica of the data axis; 0 = none
    dcn_data: int = 0

    def axis_names(self) -> Tuple[str, ...]:
        names: Tuple[str, ...] = ("data", "model")
        if self.pipe > 1:
            names = ("pipe",) + names
        if self.dcn_data > 1:
            names = ("replica",) + names
        return names


def mesh_shape(cfg: Optional[MeshConfig], n: int
               ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, sizes) of the mesh over ``n`` ranks; raises where the
    sizes do not multiply to ``n``, with the JAX package's messages."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model)
    pipe = max(1, cfg.pipe)
    if cfg.dcn_data and cfg.dcn_data > 1:
        per_slice = n // cfg.dcn_data
        data = cfg.data if cfg.data > 0 else per_slice // (model * pipe)
        if cfg.dcn_data * pipe * data * model != n:
            raise ValueError(
                f"mesh {cfg.dcn_data}x{pipe}x{data}x{model} != {n} devices")
        if pipe > 1:
            return (("replica", "pipe", "data", "model"),
                    (cfg.dcn_data, pipe, data, model))
        return ("replica", "data", "model"), (cfg.dcn_data, data, model)
    data = cfg.data if cfg.data > 0 else n // (model * pipe)
    if pipe * data * model != n:
        raise ValueError(f"mesh {pipe}x{data}x{model} != {n} devices")
    if pipe > 1:
        return ("pipe", "data", "model"), (pipe, data, model)
    return ("data", "model"), (data, model)


def make_mesh(cfg: Optional[MeshConfig] = None,
              device_type: Optional[str] = None):
    """The ``DeviceMesh`` over the process group's ranks (row-major over
    the axes, as the JAX package reshapes its devices), with a process
    group for every combination of its axes (``axis_group``).  Every rank
    calls it, in the same order as its other collectives."""
    from torch.distributed.device_mesh import DeviceMesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs a process group: "
                           "common.dist.init_distributed_mode, or "
                           "parallel.collectives.spawn")
    n = dist.get_world_size()
    names, shape = mesh_shape(cfg, n)
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(shape)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=names)
    me = dist.get_rank()
    groups = {}
    for k in range(2, len(names) + 1):
        for combo in itertools.combinations(range(len(names)), k):
            rest = [i for i in range(len(names)) if i not in combo]
            rows = ranks.permute(*rest, *combo).reshape(
                -1, int(torch.tensor([shape[i] for i in combo]).prod()))
            for row in rows.tolist():
                g = dist.new_group(row)
                if me in row:
                    groups[tuple(names[i] for i in combo)] = g
    mesh._vct_groups = groups
    return mesh


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or a mapping already)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def axis_size(mesh, axes) -> int:
    """Ranks along ``axes`` (a name or a tuple of names); an axis the mesh
    lacks counts 1, as does ``mesh`` None."""
    if mesh is None:
        return 1
    sizes = mesh_sizes(mesh)
    out = 1
    for a in _axes(axes):
        out *= sizes.get(a, 1)
    return out


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes``, the first axis major."""
    if mesh is None:
        return 0
    idx = 0
    for a in _axes(axes):
        if a in mesh.mesh_dim_names:
            idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + \
                mesh.get_local_rank(a)
    return idx


def axis_group(mesh, axes):
    """The process group of ``axes`` (None where they hold one rank)."""
    present = tuple(a for a in _axes(axes)
                    if mesh is not None and a in mesh.mesh_dim_names
                    and axis_size(mesh, a) > 1)
    if not present:
        return None
    if len(present) == 1:
        return mesh.get_group(present[0])
    return mesh._vct_groups[present]


def data_axes(mesh) -> Tuple[str, ...]:
    """The axes the batch is split over: (replica, data)."""
    return tuple(a for a in ("replica", "data")
                 if mesh is not None and a in mesh.mesh_dim_names)


# ---------------------------------------------------------------------------
# Parameter sharding rules: (path regex, spec) — first match wins.
# Kernels are stored (in_features, out_features) so "column parallel" =
# shard axis 1 on "model", "row parallel" = shard axis 0 on "model".
# ---------------------------------------------------------------------------

# Megatron split for a transformer block: qkv/out-proj + FFN in/out.
DEFAULT_RULES: Sequence[Tuple[str, Spec]] = (
    # attention projections: q/k/v column-parallel, output row-parallel
    (r".*(\bq\b|\bk\b|\bv\b|query|key|value|qkv).*kernel", (None, "model")),
    (r".*(\bo\b|out_proj|proj|dense_out|attn_out).*kernel", ("model", None)),
    # FFN: up/gate column-parallel, down row-parallel
    (r".*(wi_0|wi_1|wi\b|fc1|gate|up_proj).*kernel", (None, "model")),
    (r".*(wo\b|fc2|down_proj).*kernel", ("model", None)),
    # embeddings: shard vocab/feature dim on model axis
    (r".*embedding", ("model", None)),
    # everything else replicated
    (r".*", ()),
)

REPLICATED_RULES: Sequence[Tuple[str, Spec]] = ((r".*", ()),)

# FSDP/ZeRO-3 layout: every large kernel shards its contraction dim over
# the DATA axis; a block gathers its kernels just in time and frees them
# after use.  Composes with the Megatron model axis; _spec_fits falls
# anything indivisible back to replication.
FSDP_RULES: Sequence[Tuple[str, Spec]] = (
    (r".*(\bq\b|\bk\b|\bv\b|query|key|value|qkv).*kernel",
     ("data", "model")),
    (r".*(\bo\b|out_proj|proj|dense_out|attn_out).*kernel",
     (("data", "model"), None)),
    (r".*(wi_0|wi_1|wi\b|fc1|gate|up_proj).*kernel", ("data", "model")),
    (r".*(wo\b|fc2|down_proj).*kernel", (("data", "model"), None)),
    (r".*kernel", ("data", None)),
    (r".*embedding", (("data", "model"), None)),
    (r".*", ()),
)


def mask_rules(rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES):
    """Masks shadow their kernels (same shape, bool) — shard identically so
    the masked matmul never gathers the mask."""
    return tuple((pat.replace("kernel", "mask"), spec) for pat, spec in rules)


def _path_str(name: str) -> str:
    return name.replace(".", "/")


def _spec_of(path: str, rules) -> Spec:
    for pat, spec in rules:
        if re.fullmatch(pat, path) or re.search(pat, path):
            return spec
    return ()


def param_partition_spec(params, rules: Sequence[Tuple[str, Spec]]
                         = DEFAULT_RULES) -> Dict[str, Spec]:
    """{dotted name: spec} of every tensor of ``params`` (a module's
    parameters, or a mapping name → tensor), matched by path regex.  As in
    the JAX package, no fallback here: ``shard_params`` applies it."""
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    return {name: _spec_of(_path_str(name), rules) for name in params}


def _spec_fits(spec: Spec, shape, mesh) -> bool:
    sizes = mesh_sizes(mesh)
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        size = 1
        for a in _axes(axis):
            size *= sizes[a]
        if dim >= len(shape) or shape[dim] % size != 0:
            return False
    return True


def fitted_specs(module: nn.Module, mesh, rules=DEFAULT_RULES
                 ) -> Dict[str, Spec]:
    """{name: spec} that ``shard_params`` places: every parameter by
    ``rules`` and every ``mask`` buffer by ``mask_rules(rules)``, each
    replicated (``()``) where its sizes do not divide."""
    out = {}
    mrules = mask_rules(rules)
    for name, t in itertools.chain(
            module.named_parameters(),
            ((n, b) for n, b in module.named_buffers()
             if n.rsplit(".", 1)[-1] == "mask")):
        spec = _spec_of(_path_str(name), mrules if name.rsplit(
            ".", 1)[-1] == "mask" else rules)
        out[name] = spec if _spec_fits(spec, tuple(t.shape), mesh) else ()
    return out


@dataclasses.dataclass
class Shard:
    """Where one sharded tensor's local block sits in the whole: its global
    shape, its spec, and per sharded dim (dim, group, ranks, index)."""

    global_shape: Tuple[int, ...]
    spec: Spec
    dims: Tuple[Tuple[int, object, int, int], ...]

    def local_of(self, whole: torch.Tensor) -> torch.Tensor:
        """This rank's block of a whole tensor."""
        for dim, _, n, idx in self.dims:
            size = whole.shape[dim] // n
            whole = whole.narrow(dim, idx * size, size)
        return whole

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's block (no gradient)."""
        from vlm_compression_tpu_torch.parallel.collectives import (
            all_gather_dim,
        )

        with torch.no_grad():
            for dim, group, _, _ in reversed(self.dims):
                local = all_gather_dim(local, group, dim)
        return local


def _shard_of(spec: Spec, shape, mesh) -> Optional[Shard]:
    dims = []
    for dim, axis in enumerate(spec):
        axes = _axes(axis)
        n = axis_size(mesh, axes)
        if n > 1:
            dims.append((dim, axis_group(mesh, axes), n,
                         axis_index(mesh, axes)))
    if not dims:
        return None
    return Shard(tuple(shape), spec, tuple(dims))


# modules whose forward reads its sharded tensors through layers.local_view
# / layers.whole; any other module holding a tensor a rule shards raises
def _aware(module: nn.Module) -> bool:
    return getattr(module, "shard_aware", False)


def _set_tensor(module: nn.Module, leaf: str, value: torch.Tensor) -> None:
    old = getattr(module, leaf)
    if isinstance(old, nn.Parameter):
        setattr(module, leaf, nn.Parameter(value,
                                           requires_grad=old.requires_grad))
    else:
        setattr(module, leaf, value)


def _check_plain_forms(module: nn.Module) -> None:
    from vlm_compression_tpu_torch.ops.bitmask import is_packed

    if getattr(module, "kernel_q4", None) is not None or (
            getattr(module, "kernel", None) is not None
            and module.kernel.dtype == torch.int8) or (
            getattr(module, "mask", None) is not None
            and is_packed(module.mask)):
        raise NotImplementedError(
            "int8, int4, W8A8 and packed-mask linears do not shard yet "
            "(ROADMAP.md, item 10)")


@torch.no_grad()
def shard_params(model: nn.Module, mesh,
                 rules: Sequence[Tuple[str, Spec]] = DEFAULT_RULES
                 ) -> nn.Module:
    """In place: every parameter ``rules`` shard, and every ``mask`` buffer
    ``mask_rules(rules)`` shard, becomes this rank's block (replicated
    where the sizes do not divide, as in the JAX package); then, where the
    mesh's ``model`` axis holds more than one rank, the towers take their
    Megatron compute plans.  The mesh is kept as ``model.parallel_mesh``."""
    specs = fitted_specs(model, mesh, rules)
    modules = dict(model.named_modules())
    for name, spec in specs.items():
        owner, _, leaf = name.rpartition(".")
        mod = modules[owner]
        t = getattr(mod, leaf)
        sh = _shard_of(spec, tuple(t.shape), mesh)
        if sh is None:
            continue
        if not _aware(mod):
            raise NotImplementedError(
                f"{name}: {type(mod).__name__} does not read a sharded "
                f"{leaf} (spec {spec})")
        _check_plain_forms(mod)
        _set_tensor(mod, leaf, sh.local_of(t).contiguous().clone())
        if not hasattr(mod, "_shards"):
            mod._shards = {}
        mod._shards[leaf] = sh
    t_model = axis_size(mesh, "model")
    if t_model > 1:
        group = axis_group(mesh, "model")
        rank = axis_index(mesh, "model")
        for mod in model.modules():
            fn = getattr(mod, "tensor_parallel_", None)
            if fn is not None:
                fn(group, t_model, rank)
    model.parallel_mesh = mesh
    return model


@torch.no_grad()
def gather_params(model: nn.Module) -> nn.Module:
    """The inverse of ``shard_params``, in place: every sharded tensor whole
    again on every rank, the compute plans dropped.  Every rank calls it."""
    from vlm_compression_tpu_torch.models.layers import clear_tensor_parallel_

    for mod in model.modules():
        shards = getattr(mod, "_shards", None)
        if not shards:
            continue
        for leaf, sh in sorted(shards.items()):
            _set_tensor(mod, leaf, sh.gather(getattr(mod, leaf)))
        mod._shards = {}
    clear_tensor_parallel_(model)
    model.parallel_mesh = None
    return model


class DataSharding:
    """This rank's slice of a global batch over (``replica``, ``data``):
    the port's counterpart of the JAX package's batch ``NamedSharding``.
    ``shard(x)`` takes a tensor, an array or a dict of them (leading dim
    the batch, divisible by the data ranks)."""

    def __init__(self, mesh):
        self.axes = data_axes(mesh)
        self.size = axis_size(mesh, self.axes)
        self.index = axis_index(mesh, self.axes)

    def __call__(self, x):
        if isinstance(x, dict):
            return {k: self(v) for k, v in x.items()}
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        b = x.shape[0]
        if b % self.size:
            raise ValueError(f"batch {b} not divisible by {self.size} data "
                             "ranks")
        per = b // self.size
        return x[self.index * per:(self.index + 1) * per]


def data_sharding(mesh) -> DataSharding:
    """Batch-dim sharding for input arrays: over (replica, data)."""
    return DataSharding(mesh)
