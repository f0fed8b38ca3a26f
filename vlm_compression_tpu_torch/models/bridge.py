"""Weight bridge: JAX-package variables ⇄ the port's modules, and a seeded
random init at full width.

The port keeps the JAX package's layout and names (kernels (in, out), bool
masks (in, out), ``blocks_<i>``, ``attn/qkv``, …), so the bridge only
renames: the Flax path ``params/visual_encoder/blocks_0/attn/qkv/kernel``
is the port's parameter ``visual_encoder.blocks_0.attn.qkv.kernel``,
``masks/…/qkv/mask`` the ``mask`` buffer of that linear, and
``lora/…/qkv/lora_a`` (``lora_b``) its adapter parameters.  Variables
arrive as a nested dict of numpy arrays (``params``, and ``masks`` and
``lora`` where present).  Loading real checkpoints through ``models/convert.py`` waits
until weights are in the repository.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from vlm_compression_tpu_torch.models.layers import (
    SparseLinear,
    init_lora_,
    set_mask,
)


def flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def to_torch(arr) -> torch.Tensor:
    """numpy (or array-like) → CPU tensor; bfloat16 travels as its bits."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


@torch.no_grad()
def load_jax_variables(model: nn.Module, variables: dict,
                       strict: bool = True) -> nn.Module:
    """Copy a JAX variables tree into ``model`` in place.  ``strict``
    requires every parameter of the model to be covered."""
    named = dict(model.named_parameters())
    seen = set()
    leaves = list(flatten(variables.get("params", {})).items())
    leaves += [(path, leaf) for path, leaf in
               flatten(variables.get("lora", {})).items()]
    for path, leaf in leaves:
        name = ".".join(path)
        if name not in named:
            raise KeyError(f"no parameter {name!r} in {type(model).__name__}")
        p, t = named[name], to_torch(leaf)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: {tuple(t.shape)} vs {tuple(p.shape)}")
        p.copy_(t.to(p.dtype))
        seen.add(name)
    if strict and set(named) - seen:
        raise KeyError(f"parameters missing from the variables: "
                       f"{sorted(set(named) - seen)[:8]}")
    for path, leaf in flatten(variables.get("masks", {})).items():
        if path[-1] != "mask":
            raise KeyError(f"unexpected mask leaf {'/'.join(path)}")
        set_mask(model.get_submodule(".".join(path[:-1])),
                 to_torch(leaf).bool())
    return model


def export_masks(model: nn.Module) -> Dict[Tuple[str, ...], np.ndarray]:
    """{linear path: bool (in, out)} for every linear that holds a mask."""
    return {tuple(name.split(".")): m.mask.cpu().numpy()
            for name, m in model.named_modules()
            if isinstance(m, SparseLinear) and m.mask is not None}


@torch.no_grad()
def random_init_(model: nn.Module, seed: int = 0, std: float = 0.02
                 ) -> nn.Module:
    """Seeded random weights in place, on the model's own device: N(0, std)
    for kernels, embeddings and tokens; ones for norm scales; zeros for
    biases.  Base parameters are drawn in name order from one generator;
    LoRA adapters (A he-uniform, B zeros) from a second one, so a model
    with adapters draws the same base weights as one without."""
    gen = None
    for name, p in sorted(model.named_parameters()):
        if name.rsplit(".", 1)[-1] in ("lora_a", "lora_b"):
            continue
        if gen is None:
            gen = torch.Generator(device=p.device).manual_seed(seed)
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "scale":
            p.fill_(1.0)
        elif leaf in ("bias", "q_bias", "v_bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=gen)
    return init_lora_(model, seed + 1)
