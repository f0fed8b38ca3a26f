"""Stage-1 BLIP-2 Q-Former: ITC + ITM + LM heads, and the retrieval score
matrices (port of ``vlm_compression_tpu/models/blip2_qformer.py``, with
``Blip2ITM`` from ``vlm_compression_tpu/models/t5_plain.py:59-80``).

EVA-ViT-g → ``ln_vision`` → Q-Former, then three heads: ``vision_proj`` /
``text_proj`` (the image-text contrastive features, unit norm), ``itm_head``
(2-way match logits, the mean over the query positions) and ``lm_head``
(the caption LM over [queries ⊕ causal text]).  The heads run ``dense`` in
float32, as in the JAX package.  Hard negatives for the ITM loss are the
argmax of the masked similarities (in-batch, deterministic).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple

import numpy as np
import torch
from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.eva_vit import EvaViT, EvaViTConfig
from vlm_compression_tpu_torch.models.layers import LayerNorm, SparseLinear
from vlm_compression_tpu_torch.models.qformer import QFormer, QFormerConfig
from vlm_compression_tpu_torch.models.t5 import cross_entropy_loss

TEMP_INIT = 0.07


@dataclasses.dataclass(frozen=True)
class Blip2QformerConfig:
    vit: EvaViTConfig = dataclasses.field(default_factory=EvaViTConfig)
    qformer: QFormerConfig = dataclasses.field(default_factory=QFormerConfig)
    embed_dim: int = 256
    max_txt_len: int = 32

    @staticmethod
    def tiny(**kw) -> "Blip2QformerConfig":
        d = dict(vit=EvaViTConfig.tiny(), qformer=QFormerConfig.tiny(),
                 embed_dim=8)
        d.update(kw)
        return Blip2QformerConfig(**d)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


class Blip2Qformer(nn.Module):
    """Built on the card unless ``device`` says otherwise (raises without a
    GPU when no device is given).  ``temp`` starts at 0.07; the other
    parameters start uninitialized: load them with ``models/bridge.py``."""

    def __init__(self, cfg: Blip2QformerConfig, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        hd = cfg.qformer.hidden_size
        self.visual_encoder = EvaViT(cfg.vit, device)
        self.ln_vision = LayerNorm(cfg.vit.embed_dim, 1e-6, device)
        self.qformer = QFormer(cfg.qformer, device)
        self.vision_proj = SparseLinear(hd, cfg.embed_dim, device=device)
        self.text_proj = SparseLinear(hd, cfg.embed_dim, device=device)
        self.itm_head = SparseLinear(hd, 2, device=device)
        self.lm_head = SparseLinear(hd, cfg.qformer.vocab_size, device=device)
        self.temp = nn.Parameter(torch.tensor(TEMP_INIT, dtype=torch.float32,
                                              device=device))

    @property
    def device(self) -> torch.device:
        return self.temp.device

    # -- feature branches ----------------------------------------------
    def image_embeds(self, image, vit_mode="masked"):
        feats = self.visual_encoder(image, mode=vit_mode)
        return self.ln_vision(feats.float())

    def image_features(self, embeds, qformer_mode="masked"):
        """(query hidden (b, nq, h), unit-norm ITC features (b, nq, e)) of
        ``image_embeds``' output."""
        q = self.qformer(embeds, mode=qformer_mode)
        q = q[:, :self.cfg.qformer.num_query_tokens]
        return q, _unit(self.vision_proj(q.float(), mode="dense"))

    def forward_image(self, image, vit_mode="masked", qformer_mode="masked"):
        return self.image_features(self.image_embeds(image, vit_mode),
                                   qformer_mode)

    def _text_feature(self, h):
        return _unit(self.text_proj(h[:, 0].float(), mode="dense"))

    def forward_text(self, text_ids, text_mask=None, qformer_mode="masked"):
        """Unit-norm ITC feature of the text's first ([CLS]) position."""
        return self._text_feature(self.qformer.forward_text(
            text_ids, text_mask, mode=qformer_mode))

    def itm_logits(self, image_embeds, text_ids, text_mask,
                   qformer_mode="masked"):
        """2-way match logits, the mean over the query positions."""
        out = self.qformer.forward_multimodal(image_embeds, text_ids,
                                              text_mask, mode=qformer_mode)
        q = out[:, :self.cfg.qformer.num_query_tokens]
        return self.itm_head(q.float(), mode="dense").mean(1)

    def extract_features(self, samples, mode="multimodal", vit_mode="masked",
                         qformer_mode="masked"):
        """The ``blip2_feature_extractor`` API: mode "image" → the query
        hidden states and their unit-norm ITC projection; "text" → the
        text hidden states and the unit-norm [CLS] projection;
        "multimodal" → the query positions of the image-grounded text
        pass."""
        if mode not in ("image", "text", "multimodal"):
            raise ValueError(f"mode {mode!r}")
        out = dict.fromkeys(("image_embeds", "image_embeds_proj",
                             "text_embeds", "text_embeds_proj",
                             "multimodal_embeds"))
        if mode == "image":
            out["image_embeds"], out["image_embeds_proj"] = \
                self.forward_image(samples["image"], vit_mode, qformer_mode)
        elif mode == "text":
            h = self.qformer.forward_text(samples["text_ids"],
                                          samples.get("text_mask"),
                                          mode=qformer_mode)
            out["text_embeds"] = h
            out["text_embeds_proj"] = self._text_feature(h)
        else:
            embeds = self.image_embeds(samples["image"], vit_mode)
            mm = self.qformer.forward_multimodal(
                embeds, samples["text_ids"], samples.get("text_mask"),
                mode=qformer_mode)
            out["multimodal_embeds"] = \
                mm[:, :self.cfg.qformer.num_query_tokens]
        return out

    # -- stage-1 objective ---------------------------------------------
    def forward(self, image, text_ids, text_mask, vit_mode="masked",
                qformer_mode="masked"):
        """The stage-1 losses: ITC (query max-sim over the temperature),
        ITM over the argmax hard negatives, the caption LM."""
        b = image.shape[0]
        embeds = self.image_embeds(image, vit_mode)
        _, img_feat = self.image_features(embeds, qformer_mode)
        txt_feat = self.forward_text(text_ids, text_mask, qformer_mode)

        sim_q2t = torch.einsum("bqe,ce->bcq", img_feat, txt_feat)
        sim_i2t = sim_q2t.max(-1).values / self.temp
        sim_t2i = sim_i2t.T
        targets = torch.arange(b, device=image.device)
        loss_itc = 0.5 * (
            cross_entropy_loss(sim_i2t[:, None], targets[:, None])
            + cross_entropy_loss(sim_t2i[:, None], targets[:, None]))

        neg = ~torch.eye(b, dtype=torch.bool, device=image.device)
        ninf = torch.full((), float("-inf"), device=image.device)
        hard_txt = torch.where(neg, sim_i2t, ninf).argmax(1)
        hard_img = torch.where(neg, sim_t2i, ninf).argmax(1)
        pos = self.itm_logits(embeds, text_ids, text_mask, qformer_mode)
        neg_t = self.itm_logits(embeds, text_ids[hard_txt],
                                text_mask[hard_txt], qformer_mode)
        neg_i = self.itm_logits(embeds[hard_img], text_ids, text_mask,
                                qformer_mode)
        itm = torch.cat([pos, neg_t, neg_i], dim=0)
        itm_labels = torch.cat([
            torch.ones(b, dtype=torch.int64, device=image.device),
            torch.zeros(2 * b, dtype=torch.int64, device=image.device)])
        loss_itm = cross_entropy_loss(itm[:, None], itm_labels[:, None])

        lm_out = self.qformer.forward_multimodal(
            embeds, text_ids, text_mask, causal_text=True, mode=qformer_mode)
        text_h = lm_out[:, self.cfg.qformer.num_query_tokens:]
        logits = self.lm_head(text_h.float(), mode="dense")
        labels = torch.where(text_mask.bool(), text_ids.long(),
                             torch.full((), -100, device=image.device))
        loss_lm = cross_entropy_loss(logits[:, :-1], labels[:, 1:])
        return {"loss": loss_itc + loss_itm + loss_lm, "loss_itc": loss_itc,
                "loss_itm": loss_itm, "loss_lm": loss_lm}


class Blip2ITM(Blip2Qformer):
    """``forward(..., match_head=itm|itc|all)`` (JAX home:
    ``vlm_compression_tpu/models/t5_plain.py:59-80``): the ITM logits of
    each image-text pair, or its ITC score (the max over the query
    positions); "all" returns both."""

    def forward(self, image, input_ids, attention_mask=None,
                match_head: str = "itm", mode: str = "masked",
                qformer_mode: str = None, **_):
        qmode = qformer_mode or mode
        if match_head == "all":
            return {h: self(image, input_ids, attention_mask, h, mode,
                            qformer_mode) for h in ("itm", "itc")}
        if match_head == "itm":
            embeds = self.image_embeds(image, vit_mode=mode)
            return self.itm_logits(embeds, input_ids, attention_mask, qmode)
        _, fi = self.forward_image(image, vit_mode=mode, qformer_mode=qmode)
        ft = self.forward_text(input_ids, attention_mask, qformer_mode=qmode)
        return torch.einsum("bqd,bd->bq", fi, ft).max(-1).values


@torch.no_grad()
def compute_sim_matrix(model: Blip2Qformer, image_batches: Iterable,
                       text_ids, text_mask, k_test: int = 0,
                       vit_mode="masked", qformer_mode="masked",
                       text_batch: int = 256
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(score_i2t, score_t2i), float32 numpy, for the retrieval eval.

    The ITC similarity (the max over the query positions of the unit-norm
    features) ranks every pair; with ``k_test`` > 0 each image's top-k
    captions and each caption's top-k images (``np.argsort(-row)[:k]`` on
    the host, numpy's tie order) are re-scored with ``sim + itm[:, 1] −
    itm[:, 0]``, one ITM pass of k rows per image and per caption.  The
    image embeddings stay on the model's device, computed once per batch;
    the top-k indices go to the device, and the ITM logits come back, in
    one copy per direction: no host round trip per row."""
    dev = model.device
    text_ids, text_mask = (torch.as_tensor(x).to(dev)
                           for x in (text_ids, text_mask))
    txt_feats = torch.cat([
        model.forward_text(text_ids[s:s + text_batch],
                           text_mask[s:s + text_batch], qformer_mode)
        for s in range(0, text_ids.shape[0], text_batch)])     # (nt, e)
    sims, embeds = [], []
    for batch in image_batches:
        e = model.image_embeds(torch.as_tensor(batch, dtype=torch.float32)
                               .to(dev), vit_mode)
        _, f = model.image_features(e, qformer_mode)           # (b, nq, e)
        sims.append(torch.einsum("iqe,te->itq", f, txt_feats).amax(-1))
        if k_test:
            embeds.append(e)
    sim = torch.cat(sims).cpu().numpy()
    score_i2t = sim.copy()
    score_t2i = sim.T.copy()
    if not k_test:
        return score_i2t, score_t2i
    embeds = torch.cat(embeds)
    # every row's top-k on the host, moved to the device in one copy each
    i2t = np.stack([np.argsort(-row)[:k_test] for row in sim])
    t2i = np.stack([np.argsort(-col)[:k_test] for col in sim.T])
    i2t_dev, t2i_dev = (torch.from_numpy(x).to(dev) for x in (i2t, t2i))
    k_txt, k_img = i2t.shape[1], t2i.shape[1]
    logits = [model.itm_logits(embeds[i:i + 1].expand(k_txt, -1, -1),
                               text_ids[topk], text_mask[topk], qformer_mode)
              for i, topk in enumerate(i2t_dev)]
    logits += [model.itm_logits(embeds[topk],
                                text_ids[t:t + 1].expand(k_img, -1),
                                text_mask[t:t + 1].expand(k_img, -1),
                                qformer_mode)
               for t, topk in enumerate(t2i_dev)]
    itm = torch.stack(logits[:len(i2t)]).float().cpu().numpy()
    score_i2t[np.arange(len(i2t))[:, None], i2t] = \
        sim[np.arange(len(i2t))[:, None], i2t] + (itm[..., 1] - itm[..., 0])
    itm = torch.stack(logits[len(i2t):]).float().cpu().numpy()
    score_t2i[np.arange(len(t2i))[:, None], t2i] = \
        sim.T[np.arange(len(t2i))[:, None], t2i] + (itm[..., 1] - itm[..., 0])
    return score_i2t, score_t2i
