"""RunnerBase — train and evaluation orchestration (port of
``vlm_compression_tpu/runners/runner_base.py``).

It builds a loader per split (train: shuffled, ragged tail dropped,
cycling; eval: in order), hands the pruners their calibration batches,
collects the model's last activations and runs the task's evaluation over
``run.test_splits``, with the model-size accounting the metric report
carries.  Batches stay numpy on the host, as the JAX runner's do; the
tasks and the pruners move them to the model's device, and the training
loop moves each step's batch there.

Training: AdamW over the LoRA factors alone (the base frozen around them,
``tasks/retrain.RessaTrainState``), the run config's LR schedule sampled
at ``(epoch, i · accum_grad_iters)`` for optimizer step i, ``max(1, iters
// accum_grad_iters)`` steps an epoch (``iters``: ``run.iters_per_epoch``
or the loader's length), each over ``accum_grad_iters`` loader batches
concatenated (ragged lengths padded).  The trained LoRA stays in the
model.  A checkpoint is ``torch.save`` of ``{lora, opt_state (AdamW's
state_dict), step, masks}`` at ``output_dir/checkpoint_<tag>``, with
``checkpoint_meta.json`` beside it; ``run.resume_ckpt_path`` resumes from
one (the epoch after the meta file's).
"""

from __future__ import annotations

import inspect
import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from vlm_compression_tpu_torch.common import dist
from vlm_compression_tpu_torch.common.logger import MetricLogger, SmoothedValue
from vlm_compression_tpu_torch.common.optims import make_lr_scheduler
from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.datasets.loaders import (
    DataLoader,
    IterLoader,
    MultiIterLoader,
    concat_datasets,
    reorg_datasets_by_split,
)
from vlm_compression_tpu_torch.models.layers import (
    SparseLinear,
    set_mask,
    whole,
)
from vlm_compression_tpu_torch.parallel.mesh import (
    MeshConfig,
    axis_index,
    axis_size,
    data_axes,
    make_mesh,
    shard_params,
)
from vlm_compression_tpu_torch.tasks.retrain import RessaTrainState


def _concat_micro_batches(micro: List[Dict[str, Any]]
                          ) -> Dict[str, np.ndarray]:
    """Stack prepared micro-batches along the batch dim, padding ragged
    sequence lengths (labels with -100, everything else with 0)."""
    out = {}
    for k in micro[0]:
        if not isinstance(micro[0][k], np.ndarray):
            continue
        arrs = [np.asarray(m[k]) for m in micro]
        if arrs[0].ndim >= 2:
            max_len = max(a.shape[1] for a in arrs)
            fill = -100 if k == "labels" else 0
            arrs = [np.pad(a, [(0, 0), (0, max_len - a.shape[1])]
                           + [(0, 0)] * (a.ndim - 2),
                           constant_values=fill)
                    if a.shape[1] != max_len else a for a in arrs]
        out[k] = np.concatenate(arrs, axis=0)
    return out


def _get(cfg, key, default=None):
    if cfg is None:
        return default
    if hasattr(cfg, "get"):
        v = cfg.get(key, default)
    else:
        v = getattr(cfg, key, default)
    return default if v is None else v


def default_mesh(run_cfg):
    """The JAX runner's ``("data", "model")`` mesh, ``model`` from
    ``run.model_parallel``, over the process group; None in one process
    (where ``model_parallel`` must be 1)."""
    model = int(_get(run_cfg, "model_parallel", 1))
    if dist.get_world_size() == 1:
        if model > 1:
            raise ValueError(f"run.model_parallel={model} needs as many "
                             "processes (torchrun --nproc_per_node)")
        return None
    return make_mesh(MeshConfig(data=-1, model=model))


@registry.register_runner("runner_base")
class RunnerBase:
    def __init__(self, cfg, task, model, datasets: Dict, job_id: str = "job",
                 prepare_batch: Optional[Callable] = None):
        """model: the port's model (an ``nn.Module``); datasets: {name:
        {split: dataset}}; prepare_batch(samples) -> the model's keyword
        arrays (tokenization).  The mesh is the one the model was sharded
        over (``model.parallel_mesh``), else a ``(data, model)`` mesh sized
        by ``run.model_parallel`` over the process group (none in one
        process); the model is sharded over it
        (``parallel/mesh.shard_params``) before any optimizer is built,
        and the loaders cut by data rank."""
        self.config = cfg
        self.run_cfg = cfg.run_cfg if hasattr(cfg, "run_cfg") else cfg
        self.task = task
        self.model = model
        self.datasets = datasets
        self.job_id = job_id
        self.prepare_batch = prepare_batch or (lambda s: s)
        held = getattr(model, "parallel_mesh", None)
        self.mesh = held if held is not None else default_mesh(self.run_cfg)
        if self.mesh is not None and held is None:
            shard_params(model, self.mesh)

        self.start_epoch = 0
        self.max_epoch = int(_get(self.run_cfg, "max_epoch", 1))
        self.output_dir = _get(self.run_cfg, "output_dir", "output/" + job_id)
        os.makedirs(os.path.join(self.output_dir, "result"), exist_ok=True)
        self._dataloaders = None
        self._train_state = None
        self._train_step = None
        self._lr_sched = None
        # one entry per optimizer step: epoch, iter, lr, loss, ce, kl
        self.step_metrics: List[Dict[str, float]] = []

    # ------------------------------------------------------------------
    # training pieces, built on first use
    # ------------------------------------------------------------------
    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    @property
    def train_state(self) -> RessaTrainState:
        """The LoRA factors and their AdamW, over the model as it is when
        first asked for (a caller that prunes after that sets
        ``_train_state`` to None)."""
        if self._train_state is None:
            self._train_state = RessaTrainState.create(
                self.model,
                weight_decay=float(_get(self.run_cfg, "weight_decay", 0.05)),
                beta2=float(_get(self.run_cfg, "beta2", 0.999)))
        return self._train_state

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        return self.train_state.opt

    @property
    def lr_scheduler(self):
        if self._lr_sched is None:
            self._lr_sched = make_lr_scheduler(self.run_cfg)
        return self._lr_sched

    @property
    def accum_grad_iters(self) -> int:
        return int(_get(self.run_cfg, "accum_grad_iters", 1))

    @property
    def train_step(self):
        """The task's step over the current optimizer: ``step(batch, lr)
        -> {"loss", "ce", "kl"}``."""
        opt = self.optimizer
        if self._train_step is None or self._train_step[0] is not opt:
            kw = {}
            params = inspect.signature(self.task.make_train_step).parameters
            if "accum_grad_iters" in params:
                kw["accum_grad_iters"] = self.accum_grad_iters
            if "mesh" in params:
                kw["mesh"] = self.mesh
            self._train_step = (opt, self.task.make_train_step(
                self.model, opt, **kw))
        return self._train_step[1]

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
            # the ranks of one model group see the same batch: cut by the
            # data rank, not the world rank
            axes = data_axes(self.mesh)
            rank, world = ((axis_index(self.mesh, axes),
                            axis_size(self.mesh, axes))
                           if self.mesh is not None
                           else (dist.get_rank(), dist.get_world_size()))
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
        dev = self.device

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
    # training
    # ------------------------------------------------------------------
    def train(self, prune_retrain: bool = False) -> Dict[int, Dict[str, str]]:
        """Epochs from ``start_epoch`` (resumed where ``run.resume_ckpt_path``
        says): train, then validate and keep the best checkpoint where a
        ``val`` split runs (``run.valid_splits`` may rule it out), else
        checkpoint the epoch.  ``prune_retrain``: one epoch only."""
        best_agg = -1e18
        self._load_checkpoint_if_resume()
        stats_all = {}
        for epoch in range(self.start_epoch, self.max_epoch):
            stats = self.train_epoch(epoch)
            self.log_stats(stats, split_name="train")
            stats_all[epoch] = stats

            val = self.dataloaders.get("val")
            vsplits = _get(self.run_cfg, "valid_splits", None)
            if vsplits is not None and "val" not in vsplits:
                val = None
            if val is not None:
                metrics = self.eval_epoch("val")
                agg = float(metrics.get("agg_metrics", 0.0)) if metrics \
                    else 0.0
                if agg > best_agg:
                    best_agg = agg
                    self._save_checkpoint(epoch, is_best=True)
                self.log_stats(metrics or {}, split_name="val")
            else:
                self._save_checkpoint(epoch, is_best=False)
            if prune_retrain:
                break
        return stats_all

    def train_epoch(self, epoch: int) -> Dict[str, str]:
        """``max(1, iters // accum)`` optimizer steps; a finite loader is
        entered again when it runs out mid-epoch."""
        loader = self.dataloaders["train"]
        iters = int(_get(self.run_cfg, "iters_per_epoch", 0)) or len(loader)
        accum = self.accum_grad_iters
        opt_steps = max(1, iters // accum)
        logger = MetricLogger(delimiter="  ")
        logger.add_meter("lr", SmoothedValue(window_size=1, fmt="{value:.6f}"))
        logger.add_meter("loss", SmoothedValue(window_size=1,
                                               fmt="{value:.4f}"))
        state, step, dev = self.train_state, self.train_step, self.device
        it = iter(loader)

        def pull():
            nonlocal it
            try:
                return next(it)
            except StopIteration:
                it = iter(loader)
                return next(it)

        for i in logger.log_every(range(opt_steps),
                                  int(_get(self.run_cfg, "log_freq", 50)),
                                  f"Train: data epoch: [{epoch}]"):
            if accum == 1:
                batch = self.prepare_batch(pull())
            else:
                batch = _concat_micro_batches(
                    [self.prepare_batch(pull()) for _ in range(accum)])
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in batch.items()
                     if isinstance(v, np.ndarray) and v.dtype != object}
            # the schedule of the micro-iterations, sampled at the first
            # micro index of the step
            lr = self.lr_scheduler(epoch, i * accum)
            metrics = {k: float(v) for k, v in step(batch, lr).items()}
            state.step += 1
            self.step_metrics.append({"epoch": epoch, "iter": i, "lr": lr,
                                      **metrics})
            logger.update(loss=metrics["loss"], lr=lr)
        logger.synchronize_between_processes()
        return {k: f"{m.global_avg:.3f}" for k, m in logger.meters.items()}

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------
    def _ckpt_path(self, tag) -> str:
        return os.path.abspath(
            os.path.join(self.output_dir, f"checkpoint_{tag}"))

    def _masks(self) -> Dict[str, torch.Tensor]:
        """Every mask whole (gathered where it is stored sharded: every
        rank calls this)."""
        return {f"{name}.mask": whole(m, "mask") for name, m in
                self.model.named_modules()
                if isinstance(m, SparseLinear) and m.mask is not None}

    def _save_checkpoint(self, cur_epoch, is_best: bool = False):
        masks = self._masks()
        if not dist.is_main_process():
            return
        state = self.train_state
        payload = {"lora": {n: p.detach() for n, p in state.lora.items()},
                   "opt_state": state.opt.state_dict(), "step": state.step,
                   "masks": masks}
        path = self._ckpt_path("best" if is_best else cur_epoch)
        torch.save(payload, path)
        with open(os.path.join(self.output_dir, "checkpoint_meta.json"),
                  "w") as f:
            epoch = cur_epoch if isinstance(cur_epoch, int) else -1
            json.dump({"epoch": epoch, "tag": str(cur_epoch),
                       "best": bool(is_best)}, f)
        logging.info("Saved checkpoint to %s", path)

    @torch.no_grad()
    def _restore(self, path: str, with_optimizer: bool) -> None:
        """The checkpoint's LoRA and masks into the model (and its AdamW
        state and step into the train state)."""
        payload = torch.load(path, map_location=self.device,
                             weights_only=True)
        state = self.train_state
        lora = state.lora
        if set(payload["lora"]) != set(lora):
            raise KeyError(f"{path}: LoRA factors "
                           f"{sorted(set(payload['lora']) ^ set(lora))[:4]} "
                           "do not match the model's")
        for n, p in lora.items():
            p.copy_(payload["lora"][n])
        for name, mask in payload["masks"].items():
            set_mask(self.model.get_submodule(name.rpartition(".")[0]), mask)
        if with_optimizer:
            state.opt.load_state_dict(payload["opt_state"])
            state.step = int(payload["step"])

    def _load_checkpoint_if_resume(self):
        path = _get(self.run_cfg, "resume_ckpt_path")
        if not path:
            return
        path = os.path.abspath(path)
        self._restore(path, with_optimizer=True)
        meta = os.path.join(os.path.dirname(path), "checkpoint_meta.json")
        if os.path.exists(meta):
            with open(meta) as f:
                self.start_epoch = json.load(f).get("epoch", 0) + 1
        logging.info("Resumed from %s (start_epoch=%d)", path,
                     self.start_epoch)

    def _reload_best_model(self):
        path = self._ckpt_path("best")
        if os.path.exists(path):
            self._restore(path, with_optimizer=False)

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
