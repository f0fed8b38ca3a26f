"""SparseLoRA adapter state IO (port of
``vlm_compression_tpu/compression/peft_io.py``).

A RESSA checkpoint holds only the adapter-relevant leaves — the ``lora``
factors and the ``masks`` — nested as the JAX package nests its
collections ({path part: … {"lora_a", "lora_b"} / {"mask"}}), as CPU
tensors; it saves with ``torch.save`` where the JAX package uses orbax.
A packed mask travels with its ``mask_rows`` and ``mask_group``, as in the
JAX package's collection.  ``count_parameters`` follows the reference's
accounting: trainable = the LoRA factors, total = base parameters + LoRA;
``model_size_accounting`` its model-size report, and ``bytes_at_rest`` what
the weights and masks hold in memory.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch
from torch import nn

from vlm_compression_tpu_torch.ops.bitmask import infer_pack_group, is_packed
from vlm_compression_tpu_torch.ops.quant import unpack_int4

from vlm_compression_tpu_torch.models.bridge import flatten
from vlm_compression_tpu_torch.models.layers import (
    SparseLinear,
    lora_linears,
    set_mask,
)


def _put(tree: dict, name: str, leaf: str, value: torch.Tensor) -> None:
    node = tree
    for part in name.split("."):
        node = node.setdefault(part, {})
    node[leaf] = value.detach().cpu().clone()


def adapter_state(model: nn.Module) -> Dict[str, dict]:
    """{"lora": …, "masks": …} of ``model`` (collections it lacks are left
    out)."""
    out: Dict[str, dict] = {}
    for name, m in lora_linears(model):
        _put(out.setdefault("lora", {}), name, "lora_a", m.lora_a)
        _put(out["lora"], name, "lora_b", m.lora_b)
    for name, m in model.named_modules():
        if isinstance(m, SparseLinear) and m.mask is not None:
            _put(out.setdefault("masks", {}), name, "mask", m.mask)
            if is_packed(m.mask):
                node = out["masks"]
                for part in name.split("."):
                    node = node[part]
                node.update(mask_rows=m.in_features,
                            mask_group=infer_pack_group(m.in_features,
                                                        m.mask.shape[0]))
    return out


@torch.no_grad()
def attach_adapter_state(model: nn.Module, adapter: Dict[str, dict]
                         ) -> nn.Module:
    """Copy an ``adapter_state`` onto ``model`` in place."""
    for path, value in flatten(adapter.get("lora", {})).items():
        linear = model.get_submodule(".".join(path[:-1]))
        if path[-1] not in ("lora_a", "lora_b") or linear.lora_rank == 0:
            raise KeyError(f"no adapter {'/'.join(path)} in the model")
        getattr(linear, path[-1]).copy_(value)
    masks = flatten(adapter.get("masks", {}))
    for path, value in masks.items():
        if path[-1] in ("mask_rows", "mask_group"):
            continue
        if path[-1] != "mask":
            raise KeyError(f"unexpected mask leaf {'/'.join(path)}")
        set_mask(model.get_submodule(".".join(path[:-1])), value)
    return model


def save_adapter(model: nn.Module, path: str) -> str:
    path = os.path.abspath(path)
    torch.save(adapter_state(model), path)
    return path


def load_adapter(path: str) -> Dict[str, dict]:
    return torch.load(os.path.abspath(path), weights_only=True)


def count_parameters(model: nn.Module) -> Dict[str, int]:
    trainable = total = 0
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("lora_a", "lora_b"):
            trainable += p.numel()
        else:
            total += p.numel()
    return {"trainable": trainable, "total": total + trainable}


def print_trainable_parameters(model: nn.Module) -> str:
    c = count_parameters(model)
    pct = 100.0 * c["trainable"] / max(c["total"], 1)
    msg = (f"trainable params: {c['trainable']:,} || "
           f"all params: {c['total']:,} || trainable%: {pct:.4f}")
    logging.info(msg)
    return msg


def model_size_accounting(model: nn.Module) -> Dict[str, int]:
    """The reference's model-size report (JAX
    ``compression/peft_io.model_size_accounting``): ``orig_total_size`` =
    every base parameter (LoRA factors and ``kernel_scale`` excluded) and
    ``distilled_total_size`` = the parameters that survive pruning.  A 2-D
    kernel with a mask (bool or packed) counts the mask's kept entries;
    without one, its non-zero entries (float or int8); an int4
    ``kernel_q4`` counts two weights a byte, and without a mask its
    non-zero codes."""
    orig = distilled = 0
    linears = {name: m for name, m in model.named_modules()
               if isinstance(m, SparseLinear)}
    for name, p in model.named_parameters():
        owner, leaf = name.rpartition(".")[::2]
        if leaf in ("lora_a", "lora_b"):
            continue
        n = p.numel() * (2 if leaf == "kernel_q4" else 1)
        orig += n
        lin = linears.get(owner)
        kernel = leaf in ("kernel", "kernel_q4") and p.ndim == 2
        if kernel and lin is not None and lin.mask is not None:
            distilled += int(lin.bool_mask().sum())
        elif kernel and leaf == "kernel_q4":
            distilled += int(torch.count_nonzero(unpack_int4(p)))
        elif kernel:
            distilled += int(torch.count_nonzero(p))
        else:
            distilled += n
    return {"orig_total_size": orig, "distilled_total_size": distilled}


def bytes_at_rest(model: nn.Module) -> Dict[str, int]:
    """Bytes the model holds in memory, by kind: the SparseLinear kernels
    (bf16, fp32, int8, or int4 at 4 bits a weight), their masks (bool or
    packed words), their int8 and int4 scales, the LoRA factors, and
    everything else."""
    out = dict(kernels=0, masks=0, scales=0, lora=0, other=0)
    for name, m in model.named_modules():
        if isinstance(m, SparseLinear):
            out["kernels"] += (m.kernel if m.kernel is not None
                               else m.kernel_q4).nbytes
            out["masks"] += 0 if m.mask is None else m.mask.nbytes
            out["scales"] += (0 if m.kernel_scale is None
                              else m.kernel_scale.nbytes)
            out["other"] += 0 if m.bias is None else m.bias.nbytes
            if m.lora_rank:
                out["lora"] += m.lora_a.nbytes + m.lora_b.nbytes
    seen = sum(out.values())
    total = sum(t.nbytes for t in list(model.parameters())
                + list(model.buffers()))
    out["other"] += total - seen
    out["total"] = total
    return out
