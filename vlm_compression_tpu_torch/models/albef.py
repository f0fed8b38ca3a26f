"""ALBEF, the legacy LAVIS zoo's second family (port of
``vlm_compression_tpu/models/albef.py``).

ViT-B/16 and a 12-layer MED whose top half carries cross-attention to the
image (``fusion_start`` 6): the unimodal text pass runs layers
[0, fusion_start) with no encoder states, and ``fuse`` runs the rest from
those hidden states (not from token ids, as BLIP-1 does).  The losses are
the in-batch (distill=False) forms of the JAX package.  The six archs are
``albef_feature_extractor``, ``albef_retrieval``, ``albef_pretrain``,
``albef_vqa``, ``albef_nlvr`` and ``albef_classification``; each builds
only the heads it calls (``HEADS``, as in ``models/blip1.py``).
"""

from __future__ import annotations

import dataclasses

import torch

from vlm_compression_tpu_torch.models.blip1 import (
    ClassificationHead,
    FeatureExtractorHead,
    NLVRHead,
    VQAHead,
    ZooBase,
    _itc_loss,
    clamp_temp,
    hard_negatives,
    image_mask,
    itm_loss,
)
from vlm_compression_tpu_torch.models.med import MedConfig
from vlm_compression_tpu_torch.models.vit import ViTConfig


@dataclasses.dataclass(frozen=True)
class AlbefConfig:
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    med: MedConfig = dataclasses.field(
        default_factory=lambda: MedConfig(fusion_start=6))
    embed_dim: int = 256
    num_classes: int = 2
    max_txt_len: int = 30
    alpha: float = 0.4                 # distill mixing (config parity)

    @staticmethod
    def base(**kw) -> "AlbefConfig":
        return AlbefConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "AlbefConfig":
        d = dict(vit=ViTConfig.tiny(), med=MedConfig.tiny(fusion_start=1),
                 embed_dim=8, max_txt_len=8)
        d.update(kw)
        return AlbefConfig(**d)


class SplitFusion:
    """A MED split at ``cfg.med.fusion_start`` (ALBEF's and ALPRO's): the
    unimodal text runs the layers below it with no encoder states, and
    ``fuse`` the rest from those hidden states, cross-attending to the
    visual embeddings."""

    def unimodal_text(self, ids, mask, mode="masked"):
        """The pre-fusion half: layers [0, fusion_start), no encoder
        states."""
        enc = self.text_encoder
        x = enc.embed(ids)
        bias = (None if mask is None else enc.self_bias(
            mask, x.shape[0], x.shape[1], False, x.device))
        for layer in enc.layers()[:self.cfg.med.fusion_start]:
            x = layer(x, bias, None, None, mode=mode or "masked")
        return x

    def fuse(self, text_hidden, mask, visual_embeds, mode="masked"):
        return self.text_encoder(
            inputs_embeds=text_hidden, attention_mask=mask,
            encoder_hidden_states=visual_embeds,
            encoder_attention_mask=image_mask(visual_embeds),
            start_layer=self.cfg.med.fusion_start, mode=mode)


class AlbefBase(SplitFusion, ZooBase):
    def fused(self, image_embeds, ids, mask, mode="masked"):
        return self.fuse(self.unimodal_text(ids, mask, mode=mode), mask,
                         image_embeds, mode=mode)

    def itc_feats(self, image, ids, mask, mode="masked"):
        img = self.encode_image(image, mode=mode)
        txt = self.unimodal_text(ids, mask, mode=mode)
        return (self.image_feature(img, mode), self.text_feature(txt, mode),
                img, txt)

    def itm_logits(self, text_hidden, mask, image_embeds, mode="masked"):
        return self.head(self.itm_head,
                         self.fuse(text_hidden, mask, image_embeds, mode=mode),
                         mode)


class AlbefFeatureExtractor(FeatureExtractorHead, AlbefBase):
    pass


class AlbefRetrieval(AlbefBase):
    """ITC + hard-negative ITM, the in-batch form."""

    def forward(self, image, input_ids, attention_mask=None,
                mode: str = "masked"):
        return self._retrieval_losses(image, input_ids, attention_mask, mode)

    def _retrieval_losses(self, image, input_ids, attention_mask, mode):
        fi, ft, img, txt = self.itc_feats(image, input_ids, attention_mask,
                                          mode=mode)
        loss_itc, sim_i2t, _ = _itc_loss(fi, ft, clamp_temp(self.temp))
        neg = hard_negatives(sim_i2t)
        logits = torch.cat([
            self.itm_logits(txt, attention_mask, img, mode=mode),
            self.itm_logits(txt[neg], attention_mask[neg], img, mode=mode),
            self.itm_logits(txt, attention_mask, img[neg], mode=mode)])
        loss_itm = itm_loss(logits, fi.shape[0])
        return {"loss": loss_itc + loss_itm, "loss_itc": loss_itc,
                "loss_itm": loss_itm}


class AlbefPretrain(AlbefRetrieval):
    """ITC + ITM + MLM: the MLM pass re-embeds ``mlm_input_ids`` (masked
    by the caller) and scores every position with the tied LM head."""

    HEADS = ("itc", "itm", "lm")

    def forward(self, image, input_ids, attention_mask=None,
                mlm_input_ids=None, mlm_labels=None, mode: str = "masked"):
        out = self._retrieval_losses(image, input_ids, attention_mask, mode)
        if mlm_input_ids is not None:
            img = self.encode_image(image, mode=mode)
            txt = self.unimodal_text(mlm_input_ids, attention_mask,
                                     mode=mode)
            logits = self.text_encoder.lm_logits(
                self.fuse(txt, attention_mask, img, mode=mode), mode=mode)
            lp = torch.log_softmax(logits.float(), dim=-1)
            msk = (mlm_labels >= 0).float()
            tgt = mlm_labels.clamp(0, logits.shape[-1] - 1).long()
            nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
            loss_mlm = (nll * msk).sum() / msk.sum().clamp(min=1.0)
            out["loss_mlm"] = loss_mlm
            out["loss"] = out["loss"] + loss_mlm
        return out


class AlbefVQA(VQAHead, AlbefBase):
    pass


class AlbefNlvr(NLVRHead, AlbefBase):
    pass


class AlbefClassification(ClassificationHead, AlbefBase):
    pass


ALBEF_MODELS = {
    "albef_feature_extractor": AlbefFeatureExtractor,
    "albef_retrieval": AlbefRetrieval,
    "albef_pretrain": AlbefPretrain,
    "albef_vqa": AlbefVQA,
    "albef_nlvr": AlbefNlvr,
    "albef_classification": AlbefClassification,
}
