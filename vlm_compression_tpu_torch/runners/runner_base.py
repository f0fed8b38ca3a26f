"""RunnerBase — the evaluation half of the JAX package's runner (port of
``vlm_compression_tpu/runners/runner_base.py``).

It builds a loader per split (train: shuffled, ragged tail dropped,
cycling; eval: in order), hands the pruners their calibration batches,
collects the model's last activations and runs the task's evaluation over
``run.test_splits``, with the model-size accounting the metric report
carries.  Batches stay numpy on the host, as the JAX runner's do; the
tasks and the pruners move them to the model's device.

The training half (the train step, epochs, AdamW and the LR schedule) and
checkpointing come with ``cli/train.py`` (ROADMAP queue 1, item 4b): they
raise until then.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from vlm_compression_tpu_torch.common import dist
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets.loaders import (
    DataLoader,
    IterLoader,
    MultiIterLoader,
    concat_datasets,
    reorg_datasets_by_split,
)


def _get(cfg, key, default=None):
    if cfg is None:
        return default
    if hasattr(cfg, "get"):
        v = cfg.get(key, default)
    else:
        v = getattr(cfg, key, default)
    return default if v is None else v


def _training(what: str):
    return NotImplementedError(
        f"RunnerBase.{what} is the runner's training half: it comes with "
        "cli/train.py (ROADMAP queue 1, item 4b)")


@registry.register_runner("runner_base")
class RunnerBase:
    def __init__(self, cfg, task, model, datasets: Dict, job_id: str = "job",
                 prepare_batch: Optional[Callable] = None):
        """model: the port's model (an ``nn.Module``); datasets: {name:
        {split: dataset}}; prepare_batch(samples) -> the model's keyword
        arrays (tokenization)."""
        self.config = cfg
        self.run_cfg = cfg.run_cfg if hasattr(cfg, "run_cfg") else cfg
        self.task = task
        self.model = model
        self.datasets = datasets
        self.job_id = job_id
        self.prepare_batch = prepare_batch or (lambda s: s)

        self.start_epoch = 0
        self.max_epoch = int(_get(self.run_cfg, "max_epoch", 1))
        self.output_dir = _get(self.run_cfg, "output_dir", "output/" + job_id)
        os.makedirs(os.path.join(self.output_dir, "result"), exist_ok=True)
        self._dataloaders = None

    # ------------------------------------------------------------------
    # loaders
    # ------------------------------------------------------------------
    @property
    def dataloaders(self) -> Dict[str, Any]:
        """split → loader; the train datasets concatenated (or sampled by
        ``train_dataset_ratios`` when it is set)."""
        if self._dataloaders is None:
            by_split = reorg_datasets_by_split(self.datasets)
            out = {}
            rank, world = dist.get_rank(), dist.get_world_size()
            bs_train = int(_get(self.run_cfg, "batch_size_train", 8))
            bs_eval = int(_get(self.run_cfg, "batch_size_eval", 8))
            ratios = _get(self.run_cfg, "train_dataset_ratios")
            for split, dss in by_split.items():
                is_train = split == "train"
                bs = bs_train if is_train else bs_eval
                if is_train and ratios:
                    loaders = [DataLoader(d, bs, shuffle=True,
                                          drop_last=True, rank=rank,
                                          world_size=world) for d in dss]
                    out[split] = MultiIterLoader(loaders, ratios)
                else:
                    ds = dss[0] if len(dss) == 1 else concat_datasets(dss)
                    dl = DataLoader(ds, bs, shuffle=is_train,
                                    drop_last=is_train, rank=rank,
                                    world_size=world)
                    out[split] = IterLoader(dl) if is_train else dl
            self._dataloaders = out
        return self._dataloaders

    def get_dataloader_for_importance_computation(
            self, num_data: int = 128, power: int = 2, batch_size: int = 1):
        """The first ``num_data // batch_size`` prepared batches of the
        train split (else the first split), in order."""
        by_split = reorg_datasets_by_split(self.datasets)
        dss = by_split.get("train") or next(iter(by_split.values()))
        ds = dss[0] if len(dss) == 1 else concat_datasets(dss)
        dl = DataLoader(ds, batch_size, shuffle=False)
        n_batches = max(1, num_data // batch_size)

        prepared = []
        for i, b in enumerate(dl):
            if i >= n_batches:
                break
            prepared.append(self.prepare_batch(b))
        return prepared

    @torch.no_grad()
    def get_last_activations(self, num_data: int = 128, power: int = 2,
                             batch_size: int = 16) -> Dict[str, Any]:
        """The model's logits over the first test split, with the raw
        texts: padded to a common length, float32 on the host."""
        by_split = reorg_datasets_by_split(self.datasets)
        splits = _get(self.run_cfg, "test_splits") or list(by_split)
        dss = by_split.get(splits[0]) or next(iter(by_split.values()))
        ds = dss[0] if len(dss) == 1 else concat_datasets(dss)
        dl = DataLoader(ds, batch_size, shuffle=False)
        dev = next(self.model.parameters()).device

        texts, logits_list = [], []
        seen = 0
        for raw in dl:
            texts.extend(t_in + t_out for t_in, t_out in zip(
                raw["text_input"],
                raw.get("text_output", raw["text_input"])))
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in self.prepare_batch(raw).items()}
            out = self.model(**batch)
            logits_list.append(out["logits"].float().cpu().numpy())
            seen += logits_list[-1].shape[0]
            if seen >= num_data:
                break
        max_len = max(lg.shape[1] for lg in logits_list)
        padded = [np.pad(lg, ((0, 0), (0, max_len - lg.shape[1]), (0, 0)))
                  for lg in logits_list]
        return {"texts": texts, "logits": np.concatenate(padded, axis=0)}

    # ------------------------------------------------------------------
    # training and checkpoints: item 4b
    # ------------------------------------------------------------------
    def train(self, prune_retrain: bool = False):
        raise _training("train")

    def train_epoch(self, epoch: int):
        raise _training("train_epoch")

    @property
    def train_step(self):
        raise _training("train_step")

    def _save_checkpoint(self, cur_epoch, is_best: bool = False):
        raise _training("_save_checkpoint")

    def _load_checkpoint_if_resume(self):
        raise _training("_load_checkpoint_if_resume")

    def _reload_best_model(self):
        if os.path.exists(os.path.abspath(
                os.path.join(self.output_dir, "checkpoint_best"))):
            raise _training("_reload_best_model")

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def evaluate(self, cur_epoch="best", skip_reload: bool = False
                 ) -> Dict[str, Any]:
        results = {}
        if not skip_reload and cur_epoch == "best":
            self._reload_best_model()
        for split in _get(self.run_cfg, "test_splits", ["test"]):
            if split in self.dataloaders:
                results[split] = self.eval_epoch(split)
        return results

    def eval_epoch(self, split: str):
        loader = self.dataloaders[split]
        self.task.before_evaluation(model=self.model, dataset=self.datasets)
        results = self.task.evaluation(self.model, loader)
        # the model-size accounting of the metric report, once per runner:
        # the weights and masks do not change between evaluations
        sizes = getattr(self, "_model_sizes", None)
        if sizes is None:
            from vlm_compression_tpu_torch.compression.peft_io import (
                model_size_accounting,
            )

            sizes = self._model_sizes = model_size_accounting(self.model)
        return self.task.after_evaluation(
            val_result=results, split_name=split, epoch="eval",
            result_dir=os.path.join(self.output_dir, "result"), **sizes)

    def log_stats(self, stats: Dict, split_name: str = "train"):
        if not dist.is_main_process():
            return
        with open(os.path.join(self.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps(
                {f"{split_name}_{k}": v for k, v in (stats or {}).items()})
                + "\n")
