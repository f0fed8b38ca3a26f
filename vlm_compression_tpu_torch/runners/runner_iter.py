"""RunnerIter — iteration-based training with inner epochs (port of
``vlm_compression_tpu/runners/runner_iter.py``).

Training is measured in iterations: ``run.max_iters`` splits into inner
epochs of ``run.iters_per_inner_epoch`` optimizer steps, each followed by
an ``iter<n>``-stamped checkpoint and, where there is a ``val`` split,
validation.  A stream with no length (the LAION shards) trains this way."""

from __future__ import annotations

import logging
from typing import Dict

from vlm_compression_tpu_torch.common.registry import registry
from vlm_compression_tpu_torch.runners.runner_base import RunnerBase, _get


@registry.register_runner("runner_iter")
class RunnerIter(RunnerBase):
    @property
    def max_iters(self) -> int:
        return int(_get(self.run_cfg, "max_iters", 100))

    @property
    def iters_per_inner_epoch(self) -> int:
        return int(_get(self.run_cfg, "iters_per_inner_epoch",
                        self.max_iters))

    def train(self, prune_retrain: bool = False) -> Dict[int, Dict[str, str]]:
        self._load_checkpoint_if_resume()
        n_inner = max(1, self.max_iters // self.iters_per_inner_epoch)
        stats_all = {}
        for inner in range(self.start_epoch, n_inner):
            # the epoch loop with its length pinned to the inner epoch's
            self.run_cfg["iters_per_epoch"] = self.iters_per_inner_epoch
            stats = self.train_epoch(inner)
            self.log_stats(stats, split_name="train")
            stats_all[inner] = stats
            self._save_checkpoint(
                f"iter{(inner + 1) * self.iters_per_inner_epoch}")
            if self.dataloaders.get("val") is not None:
                metrics = self.eval_epoch("val")
                self.log_stats(metrics or {}, split_name="val")
            if prune_retrain:
                break
        logging.info("RunnerIter: %d inner epochs done", len(stats_all))
        return stats_all
