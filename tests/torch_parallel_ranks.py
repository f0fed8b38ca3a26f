"""Rank functions of the port's parallel tests.  Each runs inside one rank
that ``parallel.collectives.spawn`` starts; this module imports torch,
numpy and the port only (a spawned rank imports the module that defines
its function, and a JAX import would cost every rank seconds).  The JAX
comparisons happen in the test process."""

import numpy as np
import torch

from vlm_compression_tpu_torch.parallel import dryrun as D
from vlm_compression_tpu_torch.parallel.mesh import (
    MeshConfig,
    data_sharding,
    fitted_specs,
    gather_params,
    make_mesh,
    shard_params,
)


def round_trip_rank(rank, world, cfg, variables):
    """shard_params → gather_params under every rule table: bit-equal, and
    each stored block the shape its spec gives; the compressed forms and a
    module that does not read a shard raise; data_sharding cuts the batch
    over (replica, data)."""
    from vlm_compression_tpu_torch.models.layers import (
        SparseLinear,
        set_int8_kernel,
    )
    from vlm_compression_tpu_torch.ops.bitmask import pack_masks_

    out = {}
    for mesh_kw in (dict(data=2, model=2), dict(data=1, model=4),
                    dict(data=4, model=1)):
        mesh = make_mesh(MeshConfig(**mesh_kw))
        for rules in ("default", "fsdp", "replicated"):
            model = D.build_model(cfg, variables)
            before = {**{n: p.detach().clone()
                         for n, p in model.named_parameters()},
                      **{n: b.clone() for n, b in model.named_buffers()}}
            specs = fitted_specs(model, mesh, D.RULES[rules])
            shard_params(model, mesh, D.RULES[rules])
            stored = {**dict(model.named_parameters()),
                      **dict(model.named_buffers())}
            shapes_ok = True
            for name, spec in specs.items():
                want = list(before[name].shape)
                for dim, axes in enumerate(spec):
                    for a in ((axes,) if isinstance(axes, str)
                              else axes or ()):
                        want[dim] //= mesh_kw.get(a, 1)
                shapes_ok &= list(stored[name].shape) == want
            gather_params(model)
            after = {**dict(model.named_parameters()),
                     **dict(model.named_buffers())}
            key = f"{mesh_kw['data']}x{mesh_kw['model']}_{rules}"
            out[key] = dict(
                shapes_ok=shapes_ok,
                equal=set(after) == set(before) and all(
                    torch.equal(after[n], before[n]) for n in before),
                plans=sum(isinstance(m, SparseLinear) and m.tp is not None
                          for m in model.modules()))
    mesh = make_mesh(MeshConfig(data=2, model=2))
    raised = {}
    for form in ("int8", "packed"):
        model = D.build_model(cfg, variables)
        lin = model.t5_model.encoder.blocks_0.self_attn.q
        if form == "int8":
            set_int8_kernel(lin, torch.zeros(lin.kernel.shape,
                                             dtype=torch.int8),
                            torch.ones(lin.features))
        else:
            pack_masks_(model)
        try:
            shard_params(model, mesh)
            raised[form] = ""
        except NotImplementedError as e:
            raised[form] = str(e)
    cut = data_sharding(make_mesh(MeshConfig(data=2, model=1,
                                             dcn_data=2)))
    batch = cut({"x": torch.arange(8)})
    return dict(out=out, raised=raised, batch=batch["x"])


def row_linear_rank(rank, world, x, kernel, mask, lora_a, lora_b, g,
                    mesh_kw):
    """A bf16 ``SparseLinear`` run row-parallel over the mesh's ``model``
    group (its whole kernel stored, each rank computing with its rows), in
    every mode: the outputs, and in ``sparse_lora`` mode the gradients of
    Σ y ⊙ g for x and the LoRA factors (summed over ``model``, as the KD
    step sums a tensor-parallel linear's)."""
    from vlm_compression_tpu_torch.models.layers import (
        ROW,
        SparseLinear,
        contiguous_plan,
    )
    from vlm_compression_tpu_torch.parallel.mesh import axis_group
    from vlm_compression_tpu_torch.tasks.retrain import bucket_all_reduce_

    bf16 = torch.bfloat16
    mesh = make_mesh(MeshConfig(**mesh_kw))
    group = axis_group(mesh, "model")
    k_in, n_out = kernel.shape
    lin = SparseLinear(k_in, n_out, use_bias=False, param_dtype=bf16,
                       device="cpu", lora_rank=lora_a.shape[1])
    with torch.no_grad():
        lin.kernel.copy_(torch.as_tensor(kernel))
        lin.lora_a.copy_(torch.as_tensor(lora_a))
        lin.lora_b.copy_(torch.as_tensor(lora_b))
    lin.mask = torch.as_tensor(mask)
    size = mesh_kw["model"]
    lin.tp = contiguous_plan(ROW, group, size, rank % size, k_in)
    xs = torch.as_tensor(x).to(bf16)
    out = {}
    with torch.no_grad():
        for mode in ("dense", "masked"):
            out[mode] = lin(xs, mode=mode).float()
    xg = xs.clone().requires_grad_(True)
    y = lin(xg, mode="sparse_lora")
    (y.float() * torch.as_tensor(g)).sum().backward()
    bucket_all_reduce_([lin.lora_a.grad, lin.lora_b.grad], group)
    out["sparse_lora"] = y.detach().float()
    out["dx"] = xg.grad.float()
    out["da"] = lin.lora_a.grad.float()
    out["db"] = lin.lora_b.grad.float()
    # no mask: the adapter beside the plain product
    lin.mask = None
    xg = xs.clone().requires_grad_(True)
    y = lin(xg, mode="sparse_lora")
    (y.float() * torch.as_tensor(g)).sum().backward()
    out["unmasked"] = y.detach().float()
    out["unmasked_dx"] = xg.grad.float()
    return out


def train_rank(rank, world, cases):
    """Each case: ``D.kd_step_rank`` or ``D.generate_rank`` over the same
    group, in order."""
    outs = []
    for kind, args in cases:
        fn = {"kd": D.kd_step_rank, "generate": D.generate_rank,
              "prune": D.prune_rank, "attention": D.attention_rank,
              "pipeline": D.pipeline_rank, "row": row_linear_rank}[kind]
        outs.append(fn(rank, world, *args))
    return outs


class _Samples(list):
    """A map-style dataset of sample dicts, batched by stacking."""

    def collater(self, samples):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def runner_rank(rank, world, cfg, variables, samples, run_cfg, lr):
    """``RunnerBase`` over the (data, model) mesh ``run.model_parallel``
    gives: this rank's first training batch (the sample ids it loaded) and
    one KD step on it through ``train_step``."""
    from vlm_compression_tpu_torch.runners.runner_base import RunnerBase
    from vlm_compression_tpu_torch.tasks.retrain import ImageTextRetrainTask

    model = D.build_model(cfg, variables)
    task = ImageTextRetrainTask(kl_weight=run_cfg["kl_weight"],
                                T=run_cfg["T"])
    runner = RunnerBase(run_cfg, task, model,
                        {"ds": {"train": _Samples(samples)}})
    first = next(iter(runner.dataloaders["train"]))
    ids = [int(i) for i in first.pop("idx")]
    batch = D.to_device(first, "cpu")
    met = runner.train_step(batch, lr)
    lora = runner.train_state.lora
    return dict(ids=ids, data=D.axis_size(runner.mesh, "data"),
                model=D.axis_size(runner.mesh, "model"),
                sharded=any(getattr(m, "_shards", None)
                            for m in runner.model.modules()),
                step={"met": {k: float(v) for k, v in met.items()},
                      "lora": {n: p.detach() for n, p in lora.items()},
                      "grads": {n: p.grad for n, p in lora.items()}})
