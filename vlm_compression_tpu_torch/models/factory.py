"""Model factory: model config → composed InstructBLIP-T5,
InstructBLIP-Vicuna or the stage-1 BLIP-2 Q-Former (port of the
``blip2_t5_instruct`` and ``blip2_vicuna_instruct`` branches of
``vlm_compression_tpu/models/factory.py`` and of its ``blip2``,
``blip2_feature_extractor`` and ``blip2_image_text_matching`` archs).

LoRA ranks per tower follow the reference's ``tune_opt`` selector and
``lora_r_v/l/q`` flags: a tower gets its rank only when its letter is in
``tune_opt`` (V = vision, L = language, Q = Q-Former); the stage-1 archs
take none, and every ``model_type`` (``pretrain``, ``coco``, …) gives the
one full-width config, as in the JAX package.  ``kv_cache_int8`` and
``kv_cache_per_row`` reach every tower config that carries them (the JAX
factory's ``set_field_everywhere``); ``set_kv_cache_`` switches them on a
built model.  Still raising: the legacy zoo (ROADMAP queue 1, item 11)
and the JAX factory's remat knobs; ``blip2_opt`` raises too, as the JAX
factory builds no such arch either (build ``models/blip2_opt.Blip2OPT``
from its config).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike
from vlm_compression_tpu_torch.models.blip2_qformer import (
    Blip2ITM,
    Blip2Qformer,
    Blip2QformerConfig,
)
from vlm_compression_tpu_torch.models.blip2_t5_instruct import (
    Blip2T5Instruct,
    Blip2T5InstructConfig,
)
from vlm_compression_tpu_torch.models.blip2_vicuna_instruct import (
    Blip2VicunaInstruct,
    Blip2VicunaInstructConfig,
)
from vlm_compression_tpu_torch.models.bridge import random_init_
from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
from vlm_compression_tpu_torch.models.llama import LlamaConfig
from vlm_compression_tpu_torch.models.qformer import QFormerConfig
from vlm_compression_tpu_torch.models.t5 import T5Config

_NOT_PORTED = ("use_grad_checkpoint", "use_remat")
_KV_KNOBS = ("kv_cache_int8", "kv_cache_per_row")


def _get(cfg, key, default=None):
    if cfg is None:
        return default
    v = cfg.get(key, default) if hasattr(cfg, "get") else getattr(
        cfg, key, default)
    return default if v is None else v


def apply_dtype_policy(cfg, amp: bool):
    """amp=True keeps the bf16-compute defaults; amp=False rewrites every
    tower config to float32 compute and storage (the reference's
    non-autocast path)."""
    if amp:
        return cfg

    def fix(node):
        updates = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if f.name in ("dtype", "param_dtype") and v == "bfloat16":
                updates[f.name] = "float32"
            elif dataclasses.is_dataclass(v):
                updates[f.name] = fix(v)
        return dataclasses.replace(node, **updates) if updates else node

    return fix(cfg)


def set_field_everywhere(node, field: str, value):
    """Set ``field`` on every nested dataclass config that carries it."""
    if not dataclasses.is_dataclass(node):
        return node
    updates = {}
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if f.name == field:
            updates[f.name] = value
        elif dataclasses.is_dataclass(v):
            new = set_field_everywhere(v, field, value)
            if new is not v:
                updates[f.name] = new
    return dataclasses.replace(node, **updates) if updates else node


def set_kv_cache_(model: nn.Module, int8: bool = False,
                  per_row: bool = False) -> nn.Module:
    """Switch a built model's decode KV-cache storage in place (every
    module's config), weights untouched: the next generate allocates its
    caches in the new form."""
    for m in model.modules():
        cfg = getattr(m, "cfg", None)
        if dataclasses.is_dataclass(cfg):
            cfg = set_field_everywhere(cfg, "kv_cache_int8", int8)
            m.cfg = set_field_everywhere(cfg, "kv_cache_per_row", per_row)
    return model


_MODELS = {"blip2_t5_instruct": Blip2T5Instruct,
           "blip2_vicuna_instruct": Blip2VicunaInstruct,
           "blip2": Blip2Qformer, "blip2_feature_extractor": Blip2Qformer,
           "blip2_image_text_matching": Blip2ITM}
Config = Union[Blip2T5InstructConfig, Blip2VicunaInstructConfig,
               Blip2QformerConfig]


def build_model_config(model_cfg) -> Tuple[str, Config]:
    """(arch, composed config) from a model config node."""
    arch = _get(model_cfg, "arch", "blip2_t5_instruct")
    if arch == "blip2_opt":
        raise NotImplementedError(
            "arch 'blip2_opt' has no factory entry: the JAX factory cannot "
            "build it either; build models/blip2_opt.Blip2OPT from a "
            "Blip2OPTConfig")
    if arch not in _MODELS:
        raise NotImplementedError(f"arch {arch!r} is not ported yet")
    for key in _NOT_PORTED:
        if _get(model_cfg, key, False):
            raise NotImplementedError(f"{key} is not ported yet")
    size = str(_get(model_cfg, "model_type",
                    _get(model_cfg, "model_size", "flant5xl")))
    tune_opt = str(_get(model_cfg, "tune_opt", ""))
    r_v = int(_get(model_cfg, "lora_r_v", 0)) if "V" in tune_opt else 0
    r_l = int(_get(model_cfg, "lora_r_l", 0)) if "L" in tune_opt else 0
    r_q = int(_get(model_cfg, "lora_r_q", 0)) if "Q" in tune_opt else 0
    alpha = float(_get(model_cfg, "lora_alpha", 16.0))
    tiny = bool(_get(model_cfg, "tiny", False))
    if issubclass(_MODELS[arch], Blip2Qformer):
        cfg = Blip2QformerConfig.tiny() if tiny else Blip2QformerConfig()
    elif arch == "blip2_vicuna_instruct":
        if tiny:
            cfg = Blip2VicunaInstructConfig(
                vit=EvaViTConfig.tiny(lora_rank=r_v, lora_alpha=alpha),
                qformer=QFormerConfig.tiny(lora_rank=r_q, lora_alpha=alpha),
                llm=LlamaConfig.tiny(lora_rank=r_l, lora_alpha=alpha))
        else:
            llm = (LlamaConfig.vicuna_13b if "13b" in size
                   else LlamaConfig.vicuna_7b)(lora_rank=r_l,
                                               lora_alpha=alpha)
            cfg = Blip2VicunaInstructConfig(
                vit=EvaViTConfig.eva_clip_g(lora_rank=r_v, lora_alpha=alpha),
                qformer=QFormerConfig(lora_rank=r_q, lora_alpha=alpha),
                llm=llm)
    elif tiny:
        cfg = Blip2T5InstructConfig(
            vit=EvaViTConfig.tiny(lora_rank=r_v, lora_alpha=alpha),
            qformer=QFormerConfig.tiny(lora_rank=r_q, lora_alpha=alpha),
            t5=T5Config.tiny(lora_rank=r_l, lora_alpha=alpha))
    else:
        t5 = (T5Config.flan_t5_xxl if "xxl" in size
              else T5Config.flan_t5_xl)(lora_rank=r_l, lora_alpha=alpha)
        cfg = Blip2T5InstructConfig(
            vit=EvaViTConfig.eva_clip_g(lora_rank=r_v, lora_alpha=alpha),
            qformer=QFormerConfig(lora_rank=r_q, lora_alpha=alpha), t5=t5)
    for knob in _KV_KNOBS:
        if bool(_get(model_cfg, knob, False)):
            cfg = set_field_everywhere(cfg, knob, True)
    return arch, apply_dtype_policy(cfg, bool(_get(model_cfg, "amp", True)))


def build_model(model_cfg, seed: int = 0,
                device: DeviceLike = None) -> nn.Module:
    """The composed model with seeded random weights (LoRA A he-uniform, B
    zeros), on the card unless ``device`` says otherwise."""
    arch, cfg = build_model_config(model_cfg)
    return random_init_(_MODELS[arch](cfg, device=device), seed=seed)
