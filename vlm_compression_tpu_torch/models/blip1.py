"""BLIP-1, the legacy LAVIS zoo's first family (port of
``vlm_compression_tpu/models/blip1.py``).

A plain ViT (``models/vit.py``) and the MED BERT (``models/med.py``), with
the in-batch (distill=False) losses of the JAX package: ITC from the
unit-norm ``vision_proj`` / ``text_proj`` features of the CLS positions,
ITM from the fused CLS through ``itm_head``, the causal LM through the
tied head with label smoothing 0.1.  The heads run in float32 under the
caller's mode (masked products where a head holds a mask), as in the JAX
package.

The eight registered archs are classes here: ``blip_feature_extractor``,
``blip_caption`` (with ``decode_step``), ``blip_vqa`` (with
``question_states`` and ``rank_answers``), ``blip_retrieval``,
``blip_image_text_matching``, ``blip_nlvr``, ``blip_classification``
(with ``predict``) and ``blip_pretrain``.  Each builds only the heads it
calls (``HEADS``), so its parameters are the JAX tree's leaf for leaf
(Flax creates a head's parameters only where it runs).  Every model is
built on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.layers import SparseLinear
from vlm_compression_tpu_torch.models.med import MedBert, MedConfig, lm_loss
from vlm_compression_tpu_torch.models.vit import ViT, ViTConfig

TEMP_INIT = 0.07


@dataclasses.dataclass(frozen=True)
class Blip1Config:
    vit: ViTConfig = dataclasses.field(default_factory=ViTConfig)
    med: MedConfig = dataclasses.field(default_factory=MedConfig)
    embed_dim: int = 256               # ITC projection dim
    num_classes: int = 2               # classification / NLVR head
    prompt_length: int = 4             # caption prompt prefix ("a picture of")
    max_txt_len: int = 40
    alpha: float = 0.4                 # distill mixing (config parity)

    @staticmethod
    def base(**kw) -> "Blip1Config":
        d = dict(vit=ViTConfig.base(), med=MedConfig(encoder_width=768))
        d.update(kw)
        return Blip1Config(**d)

    @staticmethod
    def large(**kw) -> "Blip1Config":
        d = dict(vit=ViTConfig.large(), med=MedConfig(encoder_width=1024))
        d.update(kw)
        return Blip1Config(**d)

    @staticmethod
    def tiny(**kw) -> "Blip1Config":
        d = dict(vit=ViTConfig.tiny(), med=MedConfig.tiny(),
                 embed_dim=8, max_txt_len=8, prompt_length=1)
        d.update(kw)
        return Blip1Config(**d)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def class_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of ``labels`` under ``logits``."""
    lp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(lp, -1, labels[:, None].long()).mean()


def _itc_loss(image_feat, text_feat, temp):
    """In-batch contrastive loss, both directions averaged; returns
    (loss, sim_i2t, sim_t2i)."""
    sim_i2t = image_feat @ text_feat.T / temp
    sim_t2i = text_feat @ image_feat.T / temp
    labels = torch.arange(sim_i2t.shape[0], device=sim_i2t.device)
    return (0.5 * (class_loss(sim_i2t, labels) + class_loss(sim_t2i, labels)),
            sim_i2t, sim_t2i)


def hard_negatives(sim: torch.Tensor) -> torch.Tensor:
    """Each row's most similar other column (the in-batch hard negative)."""
    eye = torch.eye(sim.shape[0], device=sim.device, dtype=sim.dtype)
    return torch.argmax(sim - 1e9 * eye, dim=1)


class ZooBase(nn.Module):
    """The parts BLIP-1 and ALBEF share: a plain ViT, MED, the heads named
    in ``HEADS`` ("itc": ``vision_proj`` / ``text_proj``; "itm":
    ``itm_head``; "cls": ``cls_head``; "lm": MED's LM head) and ``temp``.
    Each family defines ``fused(image_embeds, ids, mask, mode)``, its way
    of fusing text with an image, which the shared heads below call.
    ``VISION`` False: no vision tower (a stage that reads another model's
    image tokens, as PNP-VQA's captioner does)."""

    HEADS = ("itc", "itm")
    VISION = True

    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        hd = cfg.med.hidden_size
        if self.VISION:
            self.visual_encoder = ViT(cfg.vit, device)
        self.text_encoder = MedBert(cfg.med, lm_head="lm" in self.HEADS,
                                    device=device)
        if "itc" in self.HEADS:
            self.vision_proj = SparseLinear(cfg.vit.embed_dim, cfg.embed_dim,
                                            device=device)
            self.text_proj = SparseLinear(hd, cfg.embed_dim, device=device)
        if "itm" in self.HEADS:
            self.itm_head = SparseLinear(hd, 2, device=device)
        if "cls" in self.HEADS:
            self.cls_head = SparseLinear(hd, cfg.num_classes, device=device)
        self.temp = nn.Parameter(torch.tensor(TEMP_INIT, dtype=torch.float32,
                                              device=device))

    @property
    def device(self) -> torch.device:
        return self.temp.device

    def encode_image(self, image, mode="masked"):
        return self.visual_encoder(image, mode=mode)

    def image_feature(self, img, mode="masked"):
        """Unit-norm ITC feature of the image's CLS position."""
        return unit(self.vision_proj(img[:, 0].float(), mode=mode))

    def text_feature(self, txt, mode="masked"):
        """Unit-norm ITC feature of the text's CLS position."""
        return unit(self.text_proj(txt[:, 0].float(), mode=mode))

    def head(self, linear: SparseLinear, fused, mode="masked"):
        """A float32 head over the fused CLS position."""
        return linear(fused[:, 0].float(), mode=mode)

    def classify(self, fused, labels=None, mode="masked"):
        logits = self.head(self.cls_head, fused, mode)
        out = {"logits": logits, "predictions": torch.argmax(logits, -1)}
        if labels is not None:
            out["loss"] = class_loss(logits, labels)
        return out

    def decoder(self, ids, mask, states, states_mask, mode="masked"):
        """Causal MED over ``ids`` cross-attending to ``states``: LM
        logits."""
        hidden = self.text_encoder(ids, mask, states, states_mask,
                                   causal=True, mode=mode)
        return self.text_encoder.lm_logits(hidden, mode=mode)


class FeatureExtractorHead:
    """``extract_features``: "image" → the image embeddings and their ITC
    feature, "text" → likewise for the text, "multimodal" → the fused
    states; "all" → every one of them."""

    HEADS = ("itc",)

    def forward(self, image=None, input_ids=None, attention_mask=None,
                extract_mode: str = "multimodal", mode: str = "masked"):
        if extract_mode == "all":
            out = dict(self(image, extract_mode="image", mode=mode))
            out.update(self(input_ids=input_ids,
                            attention_mask=attention_mask,
                            extract_mode="text", mode=mode))
            out.update(self(image, input_ids, attention_mask,
                            extract_mode="multimodal", mode=mode))
            return out
        if extract_mode == "image":
            img = self.encode_image(image, mode=mode)
            return {"image_embeds": img,
                    "image_features": self.image_feature(img, mode)}
        if extract_mode == "text":
            txt = self.unimodal_text(input_ids, attention_mask, mode=mode)
            return {"text_embeds": txt,
                    "text_features": self.text_feature(txt, mode)}
        img = self.encode_image(image, mode=mode)
        return {"multimodal_embeds": self.fused(img, input_ids,
                                                attention_mask, mode)}


class VQAHead:
    """VQA: the question fused with the image, the answer decoded by a
    second, causal pass over the same MED cross-attending to the fused
    question states."""

    HEADS = ("lm",)

    def question_states(self, image, q_ids, q_mask, mode="masked"):
        return self.fused(self.encode_image(image, mode=mode), q_ids,
                          q_mask, mode)

    def forward(self, image, input_ids, attention_mask=None, labels=None,
                answer_ids=None, answer_mask=None, mode: str = "masked"):
        q_states = self.question_states(image, input_ids, attention_mask,
                                        mode=mode)
        a_ids = answer_ids if answer_ids is not None else labels
        q_mask = (attention_mask if attention_mask is not None
                  else image_mask(q_states))
        logits = self.decoder(a_ids, answer_mask, q_states, q_mask, mode)
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = lm_loss(logits, labels,
                                  (labels >= 0).to(torch.int32))
        return out

    def rank_answers(self, image, q_ids, q_mask, cand_ids, cand_mask,
                     mode: str = "masked"):
        """(b, k) summed log-probabilities of each of the k candidate
        answers given each fused question."""
        q_states = self.question_states(image, q_ids, q_mask, mode=mode)
        b, k = q_states.shape[0], cand_ids.shape[0]
        ids = cand_ids.repeat(b, 1)
        msk = cand_mask.repeat(b, 1)
        logits = self.decoder(ids, msk,
                              q_states.repeat_interleave(k, dim=0),
                              q_mask.repeat_interleave(k, dim=0), mode)
        return rank_scores(logits, ids, msk, b, k)


class NLVRHead:
    """NLVR2: the text fused with both images' feature sequences,
    concatenated; a ``num_classes``-way head on the fused CLS."""

    HEADS = ("cls",)

    def forward(self, image0, image1, input_ids, attention_mask=None,
                labels=None, mode: str = "masked"):
        both = torch.cat([self.encode_image(image0, mode=mode),
                          self.encode_image(image1, mode=mode)], dim=1)
        return self.classify(self.fused(both, input_ids, attention_mask,
                                        mode), labels, mode)


class ClassificationHead:
    """The fused CLS through a ``num_classes``-way head; ``predict`` is the
    forward without labels."""

    HEADS = ("cls",)

    def forward(self, image, input_ids, attention_mask=None, labels=None,
                mode: str = "masked"):
        img = self.encode_image(image, mode=mode)
        return self.classify(self.fused(img, input_ids, attention_mask,
                                        mode), labels, mode)

    def predict(self, image, input_ids, attention_mask=None,
                mode: str = "masked"):
        return self(image, input_ids, attention_mask, mode=mode)


class Blip1Base(ZooBase):
    """BLIP-1's trunk: the text passes run MED from its token ids."""

    def unimodal_text(self, ids, mask, mode="masked"):
        """Text-only pass (no cross-attention: encoder states withheld)."""
        return self.text_encoder(ids, mask, None, mode=mode)

    def fusion(self, ids, mask, image_embeds, mode="masked"):
        return self.text_encoder(ids, mask, image_embeds,
                                 image_mask(image_embeds), mode=mode)

    def fused(self, image_embeds, ids, mask, mode="masked"):
        return self.fusion(ids, mask, image_embeds, mode=mode)

    def itc_feats(self, image, ids, mask, mode="masked"):
        img = self.encode_image(image, mode=mode)
        txt = self.unimodal_text(ids, mask, mode=mode)
        return self.image_feature(img, mode), self.text_feature(txt, mode), img

    def itm_logits(self, ids, mask, image_embeds, mode="masked"):
        return self.head(self.itm_head,
                         self.fusion(ids, mask, image_embeds, mode=mode),
                         mode)


def image_mask(embeds: torch.Tensor) -> torch.Tensor:
    return torch.ones(embeds.shape[:2], dtype=torch.int32,
                      device=embeds.device)


def rank_scores(logits, ids, mask, b: int, k: int) -> torch.Tensor:
    """Summed log-probabilities of each candidate's tokens after the first
    (the decoder's ``predict_answers`` scoring), as (b, k)."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tok = torch.gather(logp, -1, ids[:, 1:, None].long())[..., 0]
    return (tok * mask[:, 1:]).sum(1).reshape(b, k)


def itm_loss(logits: torch.Tensor, n_pos: int) -> torch.Tensor:
    """ITM cross entropy: the first ``n_pos`` rows match, the rest not."""
    labels = torch.cat([torch.ones(n_pos, dtype=torch.long),
                        torch.zeros(logits.shape[0] - n_pos,
                                    dtype=torch.long)]).to(logits.device)
    return class_loss(logits, labels)


def clamp_temp(temp: torch.Tensor) -> torch.Tensor:
    return temp.clamp(1e-3, 0.5)


class BlipFeatureExtractor(FeatureExtractorHead, Blip1Base):
    pass


class BlipCaption(Blip1Base):
    """Captioning: the causal decoder over the prompt and caption, cross-
    attending to the image; the loss skips the prompt's positions."""

    HEADS = ("lm",)

    def forward(self, image, input_ids, attention_mask=None, labels=None,
                mode: str = "masked"):
        img = self.encode_image(image, mode=mode)
        logits = self.decoder(input_ids, attention_mask, img, image_mask(img),
                              mode)
        out = {"logits": logits}
        if labels is not None:
            p = self.cfg.prompt_length
            lm_mask = torch.cat(
                [torch.zeros((labels.shape[0], p), dtype=torch.int32,
                             device=labels.device),
                 (labels[:, p:] >= 0).to(torch.int32)], dim=1)
            out["loss"] = lm_loss(logits, labels, lm_mask)
        return out

    def decode_step(self, image_embeds, seq_ids, seq_mask, mode="masked"):
        """LM logits of the whole sequence so far (no KV cache: each step
        re-runs the decoder, as in the JAX package)."""
        return self.decoder(seq_ids, seq_mask, image_embeds,
                            image_mask(image_embeds), mode)


class BlipVQA(VQAHead, Blip1Base):
    pass


class BlipRetrieval(Blip1Base):
    """ITC + hard-negative ITM, the in-batch form."""

    def forward(self, image, input_ids, attention_mask=None,
                mode: str = "masked"):
        fi, ft, img = self.itc_feats(image, input_ids, attention_mask,
                                     mode=mode)
        loss_itc, sim_i2t, _ = _itc_loss(fi, ft, clamp_temp(self.temp))
        neg = hard_negatives(sim_i2t)
        logits = torch.cat([
            self.itm_logits(input_ids, attention_mask, img, mode=mode),
            self.itm_logits(input_ids[neg], attention_mask[neg], img,
                            mode=mode),
            self.itm_logits(input_ids, attention_mask, img[neg], mode=mode)])
        loss_itm = itm_loss(logits, fi.shape[0])
        return {"loss": loss_itc + loss_itm, "loss_itc": loss_itc,
                "loss_itm": loss_itm}


class BlipITM(Blip1Base):
    """``match_head`` "itm" → the 2-way match logits; "itc" → the scaled
    cosine similarity of each pair; "all" → both."""

    def forward(self, image, input_ids, attention_mask=None,
                match_head: str = "itm", mode: str = "masked"):
        if match_head == "all":
            return {h: self(image, input_ids, attention_mask, h, mode)
                    for h in ("itm", "itc")}
        if match_head == "itc":
            fi, ft, _ = self.itc_feats(image, input_ids, attention_mask,
                                       mode=mode)
            return (fi * ft).sum(-1) / clamp_temp(self.temp)
        img = self.encode_image(image, mode=mode)
        return self.itm_logits(input_ids, attention_mask, img, mode=mode)


class BlipNLVR(NLVRHead, Blip1Base):
    pass


class BlipClassification(ClassificationHead, Blip1Base):
    pass


class BlipPretrain(Blip1Base):
    """ITC + ITM (hard negative images) + the captioning LM."""

    HEADS = ("itc", "itm", "lm")

    def forward(self, image, input_ids, attention_mask=None, labels=None,
                mode: str = "masked"):
        fi, ft, img = self.itc_feats(image, input_ids, attention_mask,
                                     mode=mode)
        loss_itc, sim_i2t, _ = _itc_loss(fi, ft, clamp_temp(self.temp))
        neg = hard_negatives(sim_i2t)
        logits = torch.cat([
            self.itm_logits(input_ids, attention_mask, img, mode=mode),
            self.itm_logits(input_ids, attention_mask, img[neg], mode=mode)])
        loss_itm = itm_loss(logits, fi.shape[0])
        lm_logits = self.decoder(input_ids, attention_mask, img,
                                 image_mask(img), mode)
        tgt = labels if labels is not None else input_ids
        loss_lm = lm_loss(lm_logits, tgt, (tgt >= 0).to(torch.int32))
        return {"loss": loss_itc + loss_itm + loss_lm,
                "loss_itc": loss_itc, "loss_itm": loss_itm,
                "loss_lm": loss_lm}


BLIP1_MODELS = {
    "blip_feature_extractor": BlipFeatureExtractor,
    "blip_caption": BlipCaption,
    "blip_vqa": BlipVQA,
    "blip_retrieval": BlipRetrieval,
    "blip_image_text_matching": BlipITM,
    "blip_nlvr": BlipNLVR,
    "blip_classification": BlipClassification,
    "blip_pretrain": BlipPretrain,
}
