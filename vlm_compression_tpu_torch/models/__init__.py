"""Towers and compositions of the port (EVA ViT-g, Q-Former, FlanT5,
LLaMA, OPT, InstructBLIP-T5, InstructBLIP-Vicuna, BLIP-2 OPT, the stage-1
BLIP-2 Q-Former, and the legacy zoo: the plain ViT, MED, BLIP-1, ALBEF,
ALPRO with TimeSformer, CLIP / EVA-CLIP, GPT dialogue, PNP-VQA /
Img2Prompt with the FiD reader and the plain T5), decoding, the weight bridge and the
checkpoint converters; ``load_model`` and ``load_model_and_preprocess``, the LAVIS
entry points (imports stay lazy, as in the JAX package)."""

from __future__ import annotations

from typing import Optional

from vlm_compression_tpu_torch.common.device import DeviceLike


def load_model(name: str, model_type: str = "flant5xl", is_eval: bool = False,
               checkpoint: Optional[str] = None, tiny: bool = False,
               seed: int = 0, device: DeviceLike = None):
    """The factory's model by registry name, seeded random weights, on the
    card unless ``device`` says otherwise.  ``checkpoint``: a state dict
    the port saved (``torch.save`` of ``model.state_dict()``, as
    ``cli.evaluate --save_pruned_model`` writes it), loaded with strict
    keys over the random weights (the JAX package reads an orbax directory
    there; the port does not).  ``is_eval`` is accepted for LAVIS's
    signature: the port's models hold no train-only state."""
    from vlm_compression_tpu_torch.cli.evaluate import (
        load_checkpoint,
        read_checkpoint,
    )
    from vlm_compression_tpu_torch.models.factory import build_model

    model = build_model({"arch": name, "model_type": model_type,
                         "tiny": tiny}, seed=seed, device=device)
    if checkpoint:
        load_checkpoint(model, read_checkpoint(checkpoint))
    return model


def load_model_and_preprocess(name: str, model_type: str = "flant5xl",
                              is_eval: bool = False, **kw):
    """(model, vis_processors, txt_processors): the processors are
    ``blip2_image_train`` / ``blip_image_eval`` at the vision tower's
    ``img_size`` (the ViT's, EVA-CLIP's, PNP-VQA's BLIP-1's or ALPRO's
    TimeSformer's; 224 for a model with none) and ``blip_caption``, keyed
    ``train`` and ``eval``, as the JAX package picks them.  ``kw`` goes to
    ``load_model``."""
    from vlm_compression_tpu_torch.datasets.processors import load_processor

    model = load_model(name, model_type, is_eval, **kw)
    c = model.cfg
    tower = (getattr(c, "vit", None) or getattr(c, "eva", None)
             or getattr(getattr(c, "blip", None), "vit", None)
             or getattr(c, "timesformer", None))
    img = tower.img_size if tower is not None else 224
    vis = {"train": load_processor("blip2_image_train", {"image_size": img}),
           "eval": load_processor("blip_image_eval", {"image_size": img})}
    txt = {"train": load_processor("blip_caption"),
           "eval": load_processor("blip_caption")}
    return model, vis, txt
