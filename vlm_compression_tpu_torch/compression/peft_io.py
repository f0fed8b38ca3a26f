"""SparseLoRA adapter state IO (port of
``vlm_compression_tpu/compression/peft_io.py``).

A RESSA checkpoint holds only the adapter-relevant leaves — the ``lora``
factors and the ``masks`` — nested as the JAX package nests its
collections ({path part: … {"lora_a", "lora_b"} / {"mask"}}), as CPU
tensors; it saves with ``torch.save`` where the JAX package uses orbax.
``count_parameters`` follows the reference's accounting: trainable = the
LoRA factors, total = base parameters + LoRA.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import torch
from torch import nn

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
    for path, value in flatten(adapter.get("masks", {})).items():
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
