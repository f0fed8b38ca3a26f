"""The multi-rank dry run (the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``) and the per-rank functions it, the
parallel tests and ``chip_smoke.py`` start with
``parallel.collectives.spawn``.

Each ``*_rank(rank, world, ...)`` runs inside one rank of a process group
and returns host values (tensors become numpy on the way back).  Models
come from a port config and a nested dict of numpy variables (the JAX
package's layout, through ``models/bridge.load_jax_variables``), or from a
seeded random init, so a rank needs nothing but the port.

``dryrun_multichip(n)`` spawns n gloo ranks — on the card by default
(gloo takes CUDA tensors for its collectives; the pipeline's hops are
staged through the host; n ranks share the cards round-robin), on the
CPU with ``device="cpu"`` — and runs the sections of the JAX run: the KD
step on a (data, model) mesh, a sharded Wanda toy against its unsharded
replay, the ``blipt5`` Wanda prune against an unsharded replay, a
4-stage LLaMA pipeline's loss and gradients against the sequential
blocks, head- and batch-sharded attention against the whole, and the
merge of per-rank result shards through ``tasks/base.save_result``.  It
prints one line with the JAX run's keys; the sequence-parallel T5
encoder is not ported (``sp_encoder_ok`` reads ``not_ported``;
ROADMAP.md, item 10).
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict

import numpy as np
import torch

from vlm_compression_tpu_torch.parallel import collectives as C
from vlm_compression_tpu_torch.parallel.mesh import (
    DEFAULT_RULES,
    FSDP_RULES,
    REPLICATED_RULES,
    MeshConfig,
    axis_group,
    axis_index,
    axis_size,
    data_sharding,
    gather_params,
    make_mesh,
    shard_params,
)

RULES = {"default": DEFAULT_RULES, "fsdp": FSDP_RULES,
         "replicated": REPLICATED_RULES}


def build_model(cfg, variables=None, device="cpu", seed: int = 0):
    """The port model of ``cfg`` (InstructBLIP-T5 or -Vicuna config), from
    ``variables`` (numpy, the JAX layout) or a seeded random init."""
    from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
    from vlm_compression_tpu_torch.models import blip2_vicuna_instruct as TV
    from vlm_compression_tpu_torch.models.bridge import (
        load_jax_variables,
        random_init_,
    )

    cls = (TB.Blip2T5Instruct if isinstance(cfg, TB.Blip2T5InstructConfig)
           else TV.Blip2VicunaInstruct)
    model = cls(cfg, device=device)
    if variables is None:
        random_init_(model, seed)
    else:
        load_jax_variables(model, variables)
    return model


def to_device(batch: dict, device) -> dict:
    return {k: torch.as_tensor(np.asarray(v)).to(device)
            if hasattr(v, "shape") else v for k, v in batch.items()}


def kd_step_rank(rank, world, cfg, variables, batch, mesh_kw, rules="default",
                 lr=1e-3, kl_weight=0.1, T=1.0, weight_decay=0.05,
                 device="cpu"):
    """One KD train step over a mesh: the model sharded
    by ``rules``, the global ``batch`` cut to this data rank.  Returns the
    metrics, the LoRA factors after the update and their (reduced)
    gradients, and the peak device memory."""
    from vlm_compression_tpu_torch.tasks import retrain as R

    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, variables, device)
    mesh = make_mesh(MeshConfig(**mesh_kw))
    shard_params(model, mesh, RULES[rules])
    state = R.RessaTrainState.create(model, weight_decay=weight_decay)
    step = R.make_kd_train_step(model, state.opt, kl_weight, T)
    local = data_sharding(mesh)(to_device(batch, device))
    met = step(local, lr)
    return {"met": {k: float(v) for k, v in met.items()},
            "lora": {n: p.detach() for n, p in state.lora.items()},
            "grads": {n: p.grad for n, p in state.lora.items()},
            "peak": (torch.cuda.max_memory_allocated()
                     if device != "cpu" else 0)}


def generate_rank(rank, world, cfg, variables, batch, mesh_kw, gen_kw,
                  device="cpu"):
    """``generate_t5`` over a tensor-parallel mesh (batch cut over data):
    this rank's tokens."""
    from vlm_compression_tpu_torch.models.blip2_t5_instruct import generate_t5
    from vlm_compression_tpu_torch.models.generation import GenerationConfig

    model = build_model(cfg, variables, device)
    mesh = make_mesh(MeshConfig(**mesh_kw))
    shard_params(model, mesh)
    b = data_sharding(mesh)(to_device(batch, device))
    with torch.no_grad():
        seqs = generate_t5(model, b["image"], b["input_ids"],
                           b["attention_mask"], b.get("qformer_input_ids"),
                           b.get("qformer_attention_mask"),
                           gen_cfg=GenerationConfig(**gen_kw))
    return {"tokens": seqs}


def whole_masks(model) -> Dict[str, torch.Tensor]:
    """{'/'-joined linear path: whole bool mask} of every masked linear."""
    from vlm_compression_tpu_torch.models.bridge import export_masks

    return {"/".join(p): torch.from_numpy(m)
            for p, m in export_masks(model).items()}


def prune_rank(rank, world, cfg, variables, batches, mesh_kw, pruner,
               prune_kw, device="cpu"):
    """A layer-wise pruner over a mesh: each data rank calibrates its share
    of every batch, kernels are split on their units over ``model``.
    Returns the whole masks and the whole kernels after the prune."""
    from vlm_compression_tpu_torch.compression import load_pruner

    model = build_model(cfg, variables, device)
    mesh = make_mesh(MeshConfig(**mesh_kw))
    shard_params(model, mesh)
    cut = data_sharding(mesh)
    local = [cut(to_device(b, device)) for b in batches]
    load_pruner(pruner, model, local, **prune_kw).prune(lora_model=True)
    masks = whole_masks(model)
    gather_params(model)
    kernels = {n[:-len(".kernel")].replace(".", "/"): p.detach()
               for n, p in model.named_parameters()
               if n.endswith(".kernel") and p.ndim == 2}
    return {"masks": masks, "kernels": {k: kernels[k] for k in masks}}


def attention_rank(rank, world, q, k, v, biases, scale, mesh_kw, g,
                   device="cpu"):
    """``sharded_attention_core`` on this rank's (batch, head) block of the
    global q, k, v and the global biases, then backward of
    Σ out ⊙ g (g cut likewise).  Returns the rank's out, dq, dk, dv and the
    biases' (global) gradients."""
    from vlm_compression_tpu_torch.ops.attention import sharded_attention_core

    mesh = make_mesh(MeshConfig(**mesh_kw))

    def cut(x):
        x = torch.as_tensor(np.asarray(x)).to(device)
        nb, nh = axis_size(mesh, "data"), axis_size(mesh, "model")
        ib, ih = axis_index(mesh, "data"), axis_index(mesh, "model")
        b, h = x.shape[0] // nb, x.shape[2] // nh
        return x[ib * b:(ib + 1) * b, :, ih * h:(ih + 1) * h].contiguous()

    ql, kl, vl = (cut(t).requires_grad_(True) for t in (q, k, v))
    bs = [torch.as_tensor(np.asarray(x)).to(device).requires_grad_(True)
          for x in biases]
    out = sharded_attention_core(ql, kl, vl, bs, scale=scale, mesh=mesh)
    (out.float() * cut(g).float()).sum().backward()
    return {"out": out.detach(), "dq": ql.grad, "dk": kl.grad, "dv": vl.grad,
            "dbias": [x.grad for x in bs]}


def pipeline_rank(rank, world, layers, x, tgt, n_stages, n_micro,
                  block="mlp", block_cfg=None, device="cpu"):
    """GPipe over ``n_stages`` pipe ranks (the rest data): the loss
    mean((y − tgt)²) and this stage's gradients.  ``layers``: per-layer
    {name: numpy}; ``block`` 'mlp' (tanh MLP, the JAX test's) or 'llama'
    (a ``LlamaBlock`` of ``block_cfg``, dense, causal)."""
    from vlm_compression_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        shard_stages,
        split_stages,
        stack_layer_params,
    )

    mesh = make_mesh(MeshConfig(pipe=n_stages, data=-1, model=1))
    tree = [{k: torch.as_tensor(np.asarray(v)).to(device)
             for k, v in lp.items()} for lp in layers]
    staged = shard_stages(split_stages(stack_layer_params(tree), n_stages),
                          mesh, requires_grad=True)
    block_fn = make_block_fn(block, block_cfg, device)
    xs = torch.as_tensor(np.asarray(x)).to(device)
    ts = torch.as_tensor(np.asarray(tgt)).to(device)
    if axis_size(mesh, "data") > 1:
        xs, ts = data_sharding(mesh)(xs), data_sharding(mesh)(ts)
    y = pipeline_apply(block_fn, staged, xs, mesh=mesh,
                       n_microbatches=n_micro)
    loss = torch.mean((y.float() - ts.float()) ** 2)
    loss.backward()
    return {"y": y.detach(), "loss": float(loss.detach()),
            "grads": {k: v.grad for k, v in staged.items()},
            "stage": axis_index(mesh, "pipe"),
            "host_hops": C.HOST_STAGED["hops"]}


def make_block_fn(block: str, block_cfg=None, device="cpu"):
    """The per-layer apply of ``pipeline_rank`` (and of its sequential
    reference)."""
    if block == "mlp":
        def mlp(p, h):
            return h + torch.tanh(h @ p["w1"] + p["b1"]) @ p["w2"]
        return mlp
    from vlm_compression_tpu_torch.models.llama import LlamaBlock
    from vlm_compression_tpu_torch.models.t5 import causal_mask

    blk = LlamaBlock(block_cfg, device="meta")

    def llama(p, h):
        n = h.shape[1]
        pos = torch.arange(n, device=h.device)[None].expand(h.shape[0], n)
        return torch.func.functional_call(
            blk, p, (h,), dict(mask=causal_mask(n, device=h.device),
                               positions=pos, mode="dense"))
    return llama


def sequential_reference(layers, x, tgt, block="mlp", block_cfg=None,
                         device="cpu"):
    """(output, loss, per-layer gradients) of the same blocks applied one
    after another in one process."""
    fn = make_block_fn(block, block_cfg, device)
    tree = [{k: torch.as_tensor(np.asarray(v)).to(device).requires_grad_(True)
             for k, v in lp.items()} for lp in layers]
    h = torch.as_tensor(np.asarray(x)).to(device)
    for lp in tree:
        h = fn(lp, h)
    loss = torch.mean((h.float() - torch.as_tensor(
        np.asarray(tgt)).to(device).float()) ** 2)
    loss.backward()
    return h.detach(), float(loss.detach()), [
        {k: v.grad for k, v in lp.items()} for lp in tree]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def tiny_config(lora: bool):
    from vlm_compression_tpu_torch.models import blip2_t5_instruct as TB
    from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
    from vlm_compression_tpu_torch.models.qformer import QFormerConfig
    from vlm_compression_tpu_torch.models.t5 import T5Config

    f32 = dict(param_dtype="float32", dtype="float32")
    return TB.Blip2T5InstructConfig(
        vit=EvaViTConfig.tiny(lora_rank=4 if lora else 0, **f32),
        qformer=QFormerConfig.tiny(lora_rank=2 if lora else 0,
                                   dtype="float32"),
        t5=T5Config.tiny(lora_rank=8 if lora else 0, **f32))


def tiny_batch(cfg, b: int, seed: int, lbl: int = 4) -> dict:
    rng = np.random.default_rng(seed)
    img = cfg.vit.img_size
    labels = rng.integers(3, 50, (b, lbl)).astype(np.int64)
    labels[::3, -1] = -100
    return dict(
        image=rng.standard_normal((b, img, img, 3)).astype(np.float32),
        input_ids=rng.integers(3, 50, (b, 6)).astype(np.int64),
        attention_mask=np.ones((b, 6), np.int64),
        labels=labels,
        qformer_input_ids=rng.integers(3, 50, (b, 6)).astype(np.int64),
        qformer_attention_mask=np.ones((b, 6), np.int64))


def flip_ties(got, want, metric) -> int:
    """Flipped bits of two (units, in) keep-masks, each unit's checked to
    be metric ties (spread ≤ 1e-5 of their largest value) as the JAX run
    checks them; raises otherwise."""
    flips = got != want
    for r in np.nonzero(flips.any(axis=1))[0]:
        vals = metric[r][flips[r]]
        spread = float(vals.max() - vals.min())
        if spread > 1e-5 * float(np.abs(vals).max()):
            raise AssertionError(f"unit {r}: flipped bits not metric ties")
    return int(flips.sum())


def dryrun_rank(rank, world, tmp, device="cpu"):
    from vlm_compression_tpu_torch.compression import load_pruner
    from vlm_compression_tpu_torch.models.llama import LlamaConfig
    from vlm_compression_tpu_torch.ops.masks import unstructured_mask, \
        wanda_metric
    from vlm_compression_tpu_torch.ops.stats import (
        all_reduce_calib_stats,
        init_calib_stats,
        update_calib_stats,
    )
    from vlm_compression_tpu_torch.tasks.base import BaseTask

    if device != "cpu":
        idx = rank % torch.cuda.device_count()
        torch.cuda.set_device(idx)
        device = torch.device("cuda", idx)
    torch.manual_seed(0)
    model_axis = 2 if world % 2 == 0 else 1
    mesh_kw = dict(data=-1, model=model_axis)
    data = world // model_axis
    cfg = tiny_config(lora=True)
    kd = kd_step_rank(rank, world, cfg, None, tiny_batch(cfg, 2 * data, 0),
                      mesh_kw, lr=1e-4, device=device)
    loss = kd["met"]["loss"]
    assert np.isfinite(loss), loss

    # the sharded Wanda toy: a (in, out) kernel's units over model, the
    # activations over data, the statistics summed over data
    mesh = make_mesh(MeshConfig(**mesh_kw))
    gen = torch.Generator().manual_seed(3)
    cols = 128 * model_axis
    w = torch.randn(cols, 256, generator=gen).to(device)
    acts = torch.randn(2 * data, 16, cols, generator=gen).to(device)
    stats = all_reduce_calib_stats(
        update_calib_stats(init_calib_stats(cols, device=device),
                           data_sharding(mesh)(acts)),
        axis_group(mesh, "data"))
    units = C.chunk(torch.arange(256, device=device),
                    axis_group(mesh, "model"), 0)
    met = wanda_metric(w[:, units].T, stats.scaler_row)
    mask = C.all_gather_dim(unstructured_mask(met, 0.5), axis_group(
        mesh, "model"), 0)
    ref_stats = update_calib_stats(init_calib_stats(cols, device=device),
                                   acts)
    ref_met = wanda_metric(w.T, ref_stats.scaler_row)
    ref = unstructured_mask(ref_met, 0.5)
    mismatch = flip_ties(mask.cpu().numpy(), ref.cpu().numpy(),
                         ref_met.double().cpu().numpy())
    assert mismatch <= 4, mismatch
    checksum = int((torch.arange(mask.numel(), device=device)
                    .reshape(mask.shape) * mask).sum() % 1000003)
    density = float(mask.float().mean())

    # the blipt5 Wanda prune, sharded vs an unsharded replay in each rank
    pcfg = tiny_config(lora=False)
    pbatches = [tiny_batch(pcfg, 8, 1)]
    for b in pbatches:
        b.pop("qformer_input_ids"), b.pop("qformer_attention_mask")
    pkw = dict(vit_prune_spec="2-0.5-1.0-1.0", t5_prune_spec="2-0.5-1.0-1.0",
               num_samples=8)
    sh = prune_rank(rank, world, pcfg, None, pbatches, mesh_kw,
                    "blipt5_wanda_pruner", pkw, device=device)["masks"]
    ref_model = build_model(pcfg, None, device)
    load_pruner("blipt5_wanda_pruner", ref_model,
                [to_device(b, device) for b in pbatches],
                **pkw).prune(lora_model=True)
    ref_masks = whole_masks(ref_model)
    assert set(sh) == set(ref_masks) and ref_masks
    blip_mismatch = sum(int((sh[k] != ref_masks[k]).sum()) for k in sh)
    assert blip_mismatch <= 4, blip_mismatch

    # a 4-stage LLaMA pipeline (where 4 divides the world)
    pp_loss = float("nan")
    if world % 4 == 0:
        lcfg = LlamaConfig.tiny(num_layers=8, param_dtype="float32",
                                dtype="float32")
        from vlm_compression_tpu_torch.models.bridge import random_init_
        from vlm_compression_tpu_torch.models.llama import LlamaBlock

        layers = []
        for i in range(lcfg.num_layers):
            blk = LlamaBlock(lcfg, device="cpu")
            random_init_(blk, 10 + i, std=0.2)
            layers.append({k: v.detach().numpy()
                           for k, v in blk.named_parameters()})
        bsz = 2 * (world // 4)
        g2 = torch.Generator().manual_seed(5)
        x0 = torch.randn(bsz, 8, lcfg.hidden_size, generator=g2).numpy()
        tgt = np.zeros_like(x0)
        pr = pipeline_rank(rank, world, layers, x0, tgt, 4, 2, "llama",
                           lcfg, device=device)
        _, ref_loss, _ = sequential_reference(layers, x0, tgt, "llama", lcfg,
                                              device=device)
        pp_loss = pr["loss"]
        assert abs(pp_loss - ref_loss) <= 1e-4 * max(1.0, abs(ref_loss)), (
            pp_loss, ref_loss)

    # attention, batch over data and heads over model, against the whole
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((4 * data, 16, 2 * model_axis, 8))
               .astype(np.float32) * 0.3 for _ in range(3))
    pos = rng.standard_normal((1, 2 * model_axis, 16, 16)).astype(np.float32)
    g = rng.standard_normal(q.shape).astype(np.float32)
    at = attention_rank(rank, world, q, k, v, [pos], 0.125, mesh_kw, g,
                        device=device)
    from vlm_compression_tpu_torch.ops.attention import attention_core

    tq, tk, tv, tb = (torch.tensor(t, device=device, requires_grad=True)
                      for t in (q, k, v, pos))
    out = attention_core(tq, tk, tv, [tb], scale=0.125)
    (out * torch.tensor(g, device=device)).sum().backward()
    flash_ok = bool(torch.allclose(at["dbias"][0], tb.grad, atol=1e-4))
    assert flash_ok

    # result shards merged through save_result (rank 0 merges last)
    rd = os.path.join(tmp, "result")
    final = BaseTask.save_result(
        [{"question_id": rank * 2 + j, "answer": f"a{rank}_{j}"}
         for j in range(3)], rd, "val_vqa_result",
        remove_duplicate="question_id")
    merged = None
    if rank == 0:
        import json

        with open(final) as f:
            merged = len(json.load(f))
        assert merged == 2 * (world - 1) + 3, merged
    return dict(mesh={"data": data, "model": model_axis}, loss=loss,
                checksum=checksum, density=density, mismatch=mismatch,
                blip_layers=len(ref_masks), blip_mismatch=blip_mismatch,
                pp_loss=pp_loss, flash_ok=flash_ok, merged=merged)


def dryrun_multichip(n: int = 4, timeout: float = 300.0,
                     device: str = "cuda") -> str:
    """Spawn ``n`` gloo ranks on the card (``device="cpu"``: on the CPU),
    run every section, print (and return) the JAX run's tail line.  On
    the card the kernels are built here first, so that the ranks load
    them and none builds."""
    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip: no CUDA device (pass "
                               "device='cpu' for the CPU rehearsal)")
        from vlm_compression_tpu_torch.ops import _cuda

        _cuda.build()
    with tempfile.TemporaryDirectory() as tmp:
        outs = C.spawn(dryrun_rank, n, "gloo",
                       os.path.join(tmp, "init"), timeout,
                       args=(tmp, device))
    r = outs[0]
    line = (f"dryrun_multichip ok: mesh={r['mesh']} loss={r['loss']:.4f} "
            f"prune_mask_checksum={r['checksum']} "
            f"density={r['density']:.3f} mask_equal={r['mismatch'] == 0} "
            f"mask_mismatch={r['mismatch']} "
            f"blipt5_prune_layers={r['blip_layers']} "
            f"blipt5_mask_mismatch={r['blip_mismatch']} "
            f"blipt5_mask_equal={r['blip_mismatch'] == 0} "
            f"sp_encoder_ok=not_ported pipeline_loss={r['pp_loss']:.4f} "
            f"sharded_flash_ok={r['flash_ok']} "
            f"merged_results={r['merged']}")
    print(line, flush=True)
    return line


__all__ = ["attention_rank", "build_model", "dryrun_multichip",
           "generate_rank", "kd_step_rank", "pipeline_rank", "prune_rank",
           "sequential_reference"]
