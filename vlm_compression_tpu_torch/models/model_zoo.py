"""Model-default config resolution: arch + model_type → default YAML (port
of ``vlm_compression_tpu/models/model_zoo.py``).

``Config(defaults=default_config_path)`` merges a project yaml's model
section over the default yaml of its (arch, model_type), as the JAX
package does; paths resolve to the repository's ``configs/models``.  The
mapping names every arch of the JAX package; the port's factory still
refuses the archs it cannot build.
"""

from __future__ import annotations

import os
from typing import Optional

_CONFIGS_ROOT = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "configs"))

# arch -> {model_type: path under configs/}
MODEL_CONFIG_PATHS = {
    # --- RESSA / BLIP-2 core (blip2_models/*.py) ----------------------
    "blip2_t5_instruct": {
        "flant5xl": "models/blip2_instruct_flant5xl.yaml",
        "flant5xxl": "models/blip2_instruct_flant5xxl.yaml",
    },
    "blip2_vicuna_instruct": {
        "vicuna7b": "models/blip2_instruct_vicuna7b.yaml",
        "vicuna13b": "models/blip2_instruct_vicuna13b.yaml",
    },
    "blip2_t5": {
        "pretrain_flant5xl": "models/blip2_pretrain_flant5xl.yaml",
        "pretrain_flant5xl_vitL":
            "models/blip2_pretrain_flant5xl_vitL.yaml",
        "pretrain_flant5xxl": "models/blip2_pretrain_flant5xxl.yaml",
        "caption_coco_flant5xl": "models/blip2_caption_flant5xl.yaml",
        "flant5xl": "models/blip2_pretrain_flant5xl.yaml",
        "flant5xxl": "models/blip2_pretrain_flant5xxl.yaml",
    },
    "blip2_opt": {
        "pretrain_opt2.7b": "models/blip2_pretrain_opt2.7b.yaml",
        "pretrain_opt6.7b": "models/blip2_pretrain_opt6.7b.yaml",
        "caption_coco_opt2.7b": "models/blip2_caption_opt2.7b.yaml",
        "caption_coco_opt6.7b": "models/blip2_caption_opt6.7b.yaml",
    },
    "blip2": {
        "pretrain": "models/blip2_pretrain.yaml",
        "pretrain_vitL": "models/blip2_pretrain_vitL.yaml",
        "coco": "models/blip2_coco.yaml",
    },
    "blip2_feature_extractor": {
        "pretrain": "models/blip2_pretrain.yaml",
        "pretrain_vitL": "models/blip2_pretrain_vitL.yaml",
        "coco": "models/blip2_coco.yaml",
    },
    "blip2_image_text_matching": {
        "pretrain": "models/blip2_pretrain.yaml",
        "coco": "models/blip2_coco.yaml",
    },
    # --- ALBEF (albef_models/*.py) ------------------------------------
    "albef_classification": {"ve": "models/albef_classification_ve.yaml"},
    "albef_feature_extractor": {
        "base": "models/albef_feature_extractor.yaml"},
    "albef_nlvr": {"nlvr": "models/albef_nlvr.yaml"},
    "albef_pretrain": {"base": "models/albef_pretrain_base.yaml"},
    "albef_retrieval": {
        "coco": "models/albef_retrieval_coco.yaml",
        "flickr": "models/albef_retrieval_flickr.yaml",
    },
    "albef_vqa": {
        "vqav2": "models/albef_vqav2.yaml",
        "okvqa": "models/albef_vqav2.yaml",
        "aokvqa": "models/albef_vqav2.yaml",
    },
    # --- BLIP-1 (blip_models/*.py) -------------------------------------
    "blip_caption": {
        "base_coco": "models/blip_caption_base_coco.yaml",
        "large_coco": "models/blip_caption_large_coco.yaml",
        # the reference's own coco_cap_ft_iter.yaml names the type "large"
        "large": "models/blip_caption_large_coco.yaml",
    },
    "blip_classification": {"base": "models/blip_classification_base.yaml"},
    "blip_feature_extractor": {
        "base": "models/blip_feature_extractor_base.yaml"},
    "blip_image_text_matching": {
        "base": "models/blip_itm_base.yaml",
        "large": "models/blip_itm_large.yaml",
    },
    "blip_nlvr": {"nlvr": "models/blip_nlvr.yaml"},
    "blip_pretrain": {"base": "models/blip_pretrain_base.yaml"},
    "blip_retrieval": {
        "coco": "models/blip_retrieval_coco.yaml",
        "flickr": "models/blip_retrieval_flickr.yaml",
    },
    "blip_vqa": {
        "vqav2": "models/blip_vqav2.yaml",
        "okvqa": "models/blip_vqa_okvqa.yaml",
        "aokvqa": "models/blip_vqa_aokvqa.yaml",
    },
    # --- ALPRO (alpro_models/*.py) -------------------------------------
    "alpro_qa": {
        "msrvtt": "models/alpro_qa_msrvtt.yaml",
        "msvd": "models/alpro_qa_msvd.yaml",
    },
    "alpro_retrieval": {
        "msrvtt": "models/alpro_retrieval_msrvtt.yaml",
        "didemo": "models/alpro_retrieval_didemo.yaml",
    },
    # --- CLIP / EVA-CLIP (clip_models, eva-clip) ------------------------
    "clip": {
        "ViT-B-32": "models/clip_vit_base32.yaml",
        "ViT-B-16": "models/clip_vit_base16.yaml",
        "ViT-L-14": "models/clip_vit_large14.yaml",
        "ViT-L-14-336": "models/clip_vit_large14_336.yaml",
        "RN50": "models/clip_resnet50.yaml",
    },
    "clip_feature_extractor": {
        "ViT-B-32": "models/clip_vit_base32.yaml",
        "ViT-B-16": "models/clip_vit_base16.yaml",
        "ViT-L-14": "models/clip_vit_large14.yaml",
        "ViT-L-14-336": "models/clip_vit_large14_336.yaml",
        "RN50": "models/clip_resnet50.yaml",
    },
    "eva_clip": {
        "eva_clip_g": "models/eva_clip_g.yaml",
        "eva_clip_g_336": "models/eva_clip_g_336.yaml",
        # project-yaml spellings (reference eva_clip/exp_*_eval.yaml)
        "EVA-CLIP-g": "models/eva_clip_g.yaml",
        "EVA-CLIP-g-336": "models/eva_clip_g_336.yaml",
    },
    "eva_clip_feature_extractor": {
        "eva_clip_g": "models/eva_clip_g.yaml",
        "EVA-CLIP-g": "models/eva_clip_g.yaml",
    },
    # --- dialogue / PNP-VQA / T5 ----------------------------------------
    "gpt_dialogue": {"base": "models/gpt_dialogue_base.yaml"},
    "pnp_vqa": {
        "base": "models/pnp-vqa/pnp_vqa_base.yaml",
        "large": "models/pnp-vqa/pnp_vqa_large.yaml",
        "3b": "models/pnp-vqa/pnp_vqa_3b.yaml",
    },
    "img2prompt_vqa": {
        "base": "models/img2prompt-vqa/img2prompt_vqa_base.yaml"},
    "t5": {
        "flant5xl": "models/t5/flant5xl.yaml",
        "flant5xxl": "models/t5/flant5xxl.yaml",
    },
}


def default_config_path(arch: Optional[str],
                        model_type: Optional[str] = None) -> Optional[str]:
    """Absolute default-YAML path for (arch, model_type), or None.

    Passed as ``Config(defaults=...)`` so user project yamls merge OVER
    the model defaults.  Unknown archs or
    types resolve to None — the project yaml then stands alone."""
    types = MODEL_CONFIG_PATHS.get(arch or "")
    if not types:
        return None
    rel = types.get(str(model_type)) if model_type is not None else None
    if rel is None and len(types) == 1:
        rel = next(iter(types.values()))
    if rel is None:
        return None
    path = os.path.join(_CONFIGS_ROOT, rel)
    return path if os.path.exists(path) else None
