"""Model factory: model config → composed InstructBLIP-T5,
InstructBLIP-Vicuna, the stage-1 BLIP-2 Q-Former or a legacy zoo model
(port of ``vlm_compression_tpu/models/factory.py``: its
``blip2_t5_instruct`` and ``blip2_vicuna_instruct`` branches, its
``blip2``, ``blip2_feature_extractor`` and ``blip2_image_text_matching``
archs, and ``build_legacy_config``'s ``blip_*``, ``albef_*``, ``alpro_*``,
``clip*``, ``eva_clip*``, ``gpt_dialogue``, ``pnp_vqa``,
``img2prompt_vqa``, ``pnp_unifiedqav2_fid`` and ``t5`` archs).

LoRA ranks per tower follow the reference's ``tune_opt`` selector and
``lora_r_v/l/q`` flags: a tower gets its rank only when its letter is in
``tune_opt`` (V = vision, L = language, Q = Q-Former); the stage-1 archs
take none, and every ``model_type`` (``pretrain``, ``coco``, …) gives the
one full-width config, as in the JAX package.  ``kv_cache_int8`` and
``kv_cache_per_row`` reach every tower config that carries them (the JAX
factory's ``set_field_everywhere``), and so does ``use_remat`` when the
node sets ``use_grad_checkpoint`` (or, without it, ``use_remat``);
``set_kv_cache_`` and ``set_remat_`` switch them on a built model.

The zoo's configs come from the arch alone, as in the JAX package: only
``num_classes`` is read from the node, so ``blip_retrieval`` builds
ViT-B/16 at 224 whatever the yaml's ``image_size``, and every CLIP
``model_type`` builds ``ClipConfig.base()``, and ALPRO's QA yamls'
``n_frms`` 16 meets a TimeSformer of 8 frames (ROADMAP, known
differences).  ``blip2_opt`` and ``blip2_t5`` raise, as the JAX factory
builds neither (build ``models/blip2_opt.Blip2OPT`` from its config).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike
from vlm_compression_tpu_torch.models.albef import ALBEF_MODELS, AlbefConfig
from vlm_compression_tpu_torch.models.alpro import ALPRO_MODELS, AlproConfig
from vlm_compression_tpu_torch.models.blip1 import BLIP1_MODELS, Blip1Config
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
from vlm_compression_tpu_torch.models.clip_model import CLIP_MODELS, ClipConfig
from vlm_compression_tpu_torch.models.eva_vit import EvaViTConfig
from vlm_compression_tpu_torch.models.gpt_dialogue import (
    GPT_MODELS,
    GPTDialogueConfig,
)
from vlm_compression_tpu_torch.models.llama import LlamaConfig
from vlm_compression_tpu_torch.models.pnp_vqa import PNP_MODELS, PNPVQAConfig
from vlm_compression_tpu_torch.models.qformer import QFormerConfig
from vlm_compression_tpu_torch.models.t5 import T5Config
from vlm_compression_tpu_torch.models.t5_plain import PlainT5, PlainT5Config

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


def _set_knobs_(model: nn.Module, **knobs) -> nn.Module:
    """Set each knob on every module config of a built model that carries
    it, weights untouched."""
    for m in model.modules():
        cfg = getattr(m, "cfg", None)
        if dataclasses.is_dataclass(cfg):
            for field, value in knobs.items():
                cfg = set_field_everywhere(cfg, field, value)
            m.cfg = cfg
    return model


def set_kv_cache_(model: nn.Module, int8: bool = False,
                  per_row: bool = False) -> nn.Module:
    """Switch a built model's decode KV-cache storage in place: the next
    generate allocates its caches in the new form."""
    return _set_knobs_(model, kv_cache_int8=int8, kv_cache_per_row=per_row)


def set_remat_(model: nn.Module, on: bool = True) -> nn.Module:
    """Switch per-block remat in place on every tower of a built model
    that carries ``use_remat`` (EVA-ViT, T5, LLaMA)."""
    return _set_knobs_(model, use_remat=on)


_MODELS = {"blip2_t5_instruct": Blip2T5Instruct,
           "blip2_vicuna_instruct": Blip2VicunaInstruct,
           "blip2": Blip2Qformer, "blip2_feature_extractor": Blip2Qformer,
           "blip2_image_text_matching": Blip2ITM,
           **BLIP1_MODELS, **ALBEF_MODELS, **ALPRO_MODELS, **CLIP_MODELS,
           **GPT_MODELS, **PNP_MODELS, "t5": PlainT5}
Config = Union[Blip2T5InstructConfig, Blip2VicunaInstructConfig,
               Blip2QformerConfig, Blip1Config, AlbefConfig, AlproConfig,
               ClipConfig, GPTDialogueConfig, PNPVQAConfig, T5Config,
               PlainT5Config]


def build_legacy_config(arch: str, size: str, tiny: bool, model_cfg=None):
    """The config of a legacy zoo arch from its name (only
    ``num_classes`` is read from ``model_cfg``, as in the JAX package);
    None for a name that is not a ported zoo arch."""
    n_cls = int(_get(model_cfg, "num_classes", 2)) if model_cfg else 2
    if arch.startswith("blip_"):
        if tiny:
            return Blip1Config.tiny(num_classes=n_cls)
        return (Blip1Config.large(num_classes=n_cls) if "large" in size
                else Blip1Config.base(num_classes=n_cls))
    if arch.startswith("albef_"):
        return (AlbefConfig.tiny(num_classes=n_cls) if tiny
                else AlbefConfig.base(num_classes=n_cls))
    if arch in ("clip", "clip_feature_extractor"):
        return ClipConfig.tiny() if tiny else ClipConfig.base()
    if arch in ("eva_clip", "eva_clip_feature_extractor"):
        return ClipConfig.tiny_eva() if tiny else ClipConfig.eva_clip_g()
    if arch.startswith("alpro_"):
        return (AlproConfig.tiny(num_classes=n_cls) if tiny
                else AlproConfig.base(num_classes=n_cls))
    if arch == "gpt_dialogue":
        return GPTDialogueConfig.tiny() if tiny else GPTDialogueConfig.base()
    if arch in ("pnp_vqa", "img2prompt_vqa"):
        return PNPVQAConfig.tiny() if tiny else PNPVQAConfig.base()
    if arch == "pnp_unifiedqav2_fid":
        return T5Config.tiny() if tiny else T5Config.flan_t5_xl()
    if arch == "t5":
        return PlainT5Config.tiny() if tiny else PlainT5Config.flan_t5_xl()
    return None


def build_model_config(model_cfg) -> Tuple[str, Config]:
    """(arch, composed config) from a model config node."""
    arch = _get(model_cfg, "arch", "blip2_t5_instruct")
    if arch == "blip2_opt":
        raise NotImplementedError(
            "arch 'blip2_opt' has no factory entry: the JAX factory cannot "
            "build it either; build models/blip2_opt.Blip2OPT from a "
            "Blip2OPTConfig")
    if arch == "blip2_t5":
        raise NotImplementedError(
            "arch 'blip2_t5' has no factory entry: the JAX factory raises "
            "'unknown arch' for it too; the instruct yamls name "
            "blip2_t5_instruct")
    if arch not in _MODELS:
        raise NotImplementedError(f"arch {arch!r} is not ported yet")
    size = str(_get(model_cfg, "model_type",
                    _get(model_cfg, "model_size", "flant5xl")))
    tune_opt = str(_get(model_cfg, "tune_opt", ""))
    r_v = int(_get(model_cfg, "lora_r_v", 0)) if "V" in tune_opt else 0
    r_l = int(_get(model_cfg, "lora_r_l", 0)) if "L" in tune_opt else 0
    r_q = int(_get(model_cfg, "lora_r_q", 0)) if "Q" in tune_opt else 0
    alpha = float(_get(model_cfg, "lora_alpha", 16.0))
    tiny = bool(_get(model_cfg, "tiny", False))
    legacy = build_legacy_config(arch, size, tiny, model_cfg)
    if legacy is not None:
        cfg = legacy
    elif issubclass(_MODELS[arch], Blip2Qformer):
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
    if bool(_get(model_cfg, "use_grad_checkpoint",
                 _get(model_cfg, "use_remat", False))):
        # the reference's yamls carry use_grad_checkpoint: it reaches the
        # towers' use_remat
        cfg = set_field_everywhere(cfg, "use_remat", True)
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
