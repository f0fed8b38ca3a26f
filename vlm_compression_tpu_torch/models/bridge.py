"""Weight bridge: JAX-package variables ⇄ the port's modules, and a seeded
random init at full width.

The port keeps the JAX package's layout and names (kernels (in, out), bool
masks (in, out), ``blocks_<i>``, ``attn/qkv``, …), so the bridge only
renames: the Flax path ``params/visual_encoder/blocks_0/attn/qkv/kernel``
is the port's parameter ``visual_encoder.blocks_0.attn.qkv.kernel``,
``masks/…/qkv/mask`` the ``mask`` buffer of that linear, and
``lora/…/qkv/lora_a`` (``lora_b``) its adapter parameters.  Variables
arrive as a nested dict of numpy arrays (``params``, and ``masks`` and
``lora`` where present).  Compressed leaves travel bit for bit: an int8
``kernel`` with its ``kernel_scale`` (``ops/quant.py``) becomes the
linear's int8 kernel and scale buffer, a uint8 ``kernel_q4`` with its 2-D
``kernel_scale`` its int4 kernel (the float kernel removed) and scale
buffer; a packed uint32 ``mask`` with
``mask_rows``/``mask_group`` (``ops/bitmask.py``) its int32 words.
The legacy zoo's leaves take the same rename: TimeSformer's HWIO
``patch_embed`` kernel and its ``cls_token``, ``pos_embed`` and
``time_embed``; GPT's ``wte`` / ``wpe`` embeddings; the FiD reader's T5
under ``reader/t5``; PNP-VQA's ``itm`` and ``cap`` sub-trees; and the PEFT
tuners' Flax ``Dense`` kernels, (in, out) as the port keeps them.
Loading real checkpoints through ``models/convert.py`` waits until weights
are in the repository.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from vlm_compression_tpu_torch.models.blip2_qformer import TEMP_INIT
from vlm_compression_tpu_torch.models.layers import (
    SparseLinear,
    init_lora_,
    set_int4_kernel,
    set_int8_kernel,
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
    """numpy (or array-like) → CPU tensor; bfloat16 travels as its bits,
    uint32 (packed mask words) as int32 of the same bits."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32).copy())
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
    params = flatten(variables.get("params", {}))
    # int8 and int4 kernels first: they replace the float parameter of
    # their linear
    for path, leaf in list(params.items()):
        if path[-1] == "kernel" and np.asarray(leaf).dtype == np.int8:
            scale = params.pop(path[:-1] + ("kernel_scale",))
            set_int8_kernel(model.get_submodule(".".join(path[:-1])),
                            to_torch(leaf), to_torch(scale))
        elif path[-1] == "kernel_q4":
            scale = params.pop(path[:-1] + ("kernel_scale",))
            set_int4_kernel(model.get_submodule(".".join(path[:-1])),
                            to_torch(leaf), to_torch(scale))
    named = dict(model.named_parameters())
    seen = set()
    leaves = list(params.items())
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
    masks = flatten(variables.get("masks", {}))
    for path, leaf in masks.items():
        if path[-1] in ("mask_rows", "mask_group"):
            continue
        if path[-1] != "mask":
            raise KeyError(f"unexpected mask leaf {'/'.join(path)}")
        linear = model.get_submodule(".".join(path[:-1]))
        mask = to_torch(leaf)
        if mask.dtype == torch.int32:
            rows = int(masks[path[:-1] + ("mask_rows",)])
            if rows != linear.in_features:
                raise ValueError(f"{'/'.join(path)}: mask_rows {rows} vs "
                                 f"{linear.in_features} kernel rows")
        set_mask(linear, mask)
    return model


def export_masks(model: nn.Module) -> Dict[Tuple[str, ...], np.ndarray]:
    """{linear path: bool (in, out)} for every linear that holds a mask
    (packed masks unpacked)."""
    return {tuple(name.split(".")): m.bool_mask().cpu().numpy()
            for name, m in model.named_modules()
            if isinstance(m, SparseLinear) and m.mask is not None}


@torch.no_grad()
def random_init_(model: nn.Module, seed: int = 0, std: float = 0.02
                 ) -> nn.Module:
    """Seeded random weights in place, on the model's own device: N(0, std)
    for kernels, embeddings and tokens; ones for norm scales; zeros for
    biases; ``temp`` (the stage-1 Q-Former's, BLIP-1's, ALBEF's,
    ALPRO's, PNP-VQA's two) at its init, 0.07, and CLIP's ``logit_scale`` at log(1 / 0.07).  Base
    parameters are drawn in name order from one generator;
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
        elif leaf == "temp":
            p.fill_(TEMP_INIT)
        elif leaf == "logit_scale":
            p.fill_(math.log(1 / TEMP_INIT))
        elif leaf in ("bias", "q_bias", "v_bias"):
            p.zero_()
        else:
            p.normal_(0.0, std, generator=gen)
    return init_lora_(model, seed + 1)
