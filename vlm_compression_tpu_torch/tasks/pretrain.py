"""Stage-2 image-text pretraining task (plain cross-entropy, no KD; port
of ``vlm_compression_tpu/tasks/pretrain.py``).

``image_text_pretrain`` is the task that ``prune_stage2_t5_instruct.yaml``
names: the prune flow reads its calibration data through it.  Its train
step is the student half of the RESSA step (``tasks/retrain.py``): the
model in ``student_mode`` in every tower, its CE loss, one AdamW update of
the LoRA factors.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from vlm_compression_tpu_torch.common.optims import set_lr
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.tasks.base import BaseTask


@registry.register_task("image_text_pretrain")
class ImageTextPretrainTask(BaseTask):
    @classmethod
    def setup_task(cls, cfg=None, **kw):
        return cls()

    def make_train_step(self, model, opt: torch.optim.Optimizer,
                        student_mode: str = "sparse_lora") -> Callable:
        """``step(batch, lr) -> {"loss"}``: the student's loss, its
        gradients and one AdamW update at ``lr`` (the optimizer holds the
        LoRA factors, the base frozen around them, as
        ``RessaTrainState.create`` leaves it)."""

        def step(batch: dict, lr: float) -> Dict[str, torch.Tensor]:
            opt.zero_grad(set_to_none=True)
            loss = model(**batch, vit_mode=student_mode,
                         llm_mode=student_mode,
                         qformer_mode=student_mode)["loss"]
            loss.backward()
            set_lr(opt, lr)
            opt.step()
            return {"loss": loss.detach()}

        return step
