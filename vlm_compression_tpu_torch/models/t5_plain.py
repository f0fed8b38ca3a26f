"""Plain text-only T5 behind the zoo's ``t5`` arch (port of ``PlainT5`` in
``vlm_compression_tpu/models/t5_plain.py``; its ``Blip2ITM`` is in
``models/blip2_qformer.py``).

A bare ``T5ForConditionalGeneration`` named ``t5_model``: forward
(input_ids, attention_mask, labels) → the loss and logits (the logits
alone without labels), used to evaluate a pruned language tower on its
own.  Built on the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import dataclasses

from torch import nn

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device
from vlm_compression_tpu_torch.models.t5 import (
    T5Config,
    T5ForConditionalGeneration,
)


@dataclasses.dataclass(frozen=True)
class PlainT5Config:
    t5: T5Config = dataclasses.field(default_factory=T5Config)

    @staticmethod
    def flan_t5_xl(**kw) -> "PlainT5Config":
        return PlainT5Config(t5=T5Config.flan_t5_xl(), **kw)

    @staticmethod
    def tiny(**kw) -> "PlainT5Config":
        return PlainT5Config(t5=T5Config.tiny(), **kw)


class PlainT5(nn.Module):
    def __init__(self, cfg: PlainT5Config, device: DeviceLike = None):
        super().__init__()
        self.cfg = cfg
        self.t5_model = T5ForConditionalGeneration(cfg.t5,
                                                   resolve_device(device))

    @property
    def device(self):
        return self.t5_model.shared.embedding.device

    def forward(self, input_ids, attention_mask=None, labels=None,
                mode: str = "masked"):
        return self.t5_model(input_ids=input_ids,
                             attention_mask=attention_mask, labels=labels,
                             mode=mode)
