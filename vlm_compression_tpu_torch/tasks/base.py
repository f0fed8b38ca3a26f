"""BaseTask — the generic evaluation loop and result saving (port of
``vlm_compression_tpu/tasks/base.py``).

Results are saved as one JSON shard per process, merged by rank 0 into one
file (duplicates removed by a key).  Model and dataset construction come
with the runner and data layer (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Iterable

import torch


class BaseTask:
    def __init__(self, **kwargs):
        self.inst_id_key = "instance_id"

    @classmethod
    def setup_task(cls, cfg=None, **kwargs):
        return cls()

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    def build_model(self, cfg):
        raise NotImplementedError(
            "build_model from a run config comes with the port's runner and "
            "config layer (ROADMAP queue 1, item 4); build the model with "
            "models.factory.build_model")

    def build_datasets(self, cfg, max_train_samples=None):
        raise NotImplementedError(
            "dataset builders come with the port's data layer (ROADMAP "
            "queue 1, item 4); pass collated sample dicts to evaluation()")

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------
    def valid_step(self, model, samples) -> Iterable[Dict[str, Any]]:
        raise NotImplementedError

    def before_evaluation(self, model, dataset, **kwargs):
        pass

    def after_evaluation(self, val_result, **kwargs):
        return None

    def evaluation(self, model, data_loader, cuda_enabled=None):
        results = []
        for samples in data_loader:
            results.extend(self.valid_step(model=model, samples=samples))
        return results

    # ------------------------------------------------------------------
    # result IO: a JSON shard per process, merged by rank 0
    # ------------------------------------------------------------------
    @staticmethod
    def save_result(result, result_dir, filename, remove_duplicate="",
                    rank=None, world=None):
        """``rank``/``world`` default to the ``torch.distributed`` process
        group when one is initialized, else 0/1; a caller that passes them
        orders the shards' writes itself."""
        os.makedirs(result_dir, exist_ok=True)
        dist = torch.distributed.is_available() and \
            torch.distributed.is_initialized()
        real_grid = rank is None
        if rank is None:
            rank = torch.distributed.get_rank() if dist else 0
        if world is None:
            world = torch.distributed.get_world_size() if dist else 1
        shard = os.path.join(result_dir, f"{filename}_rank{rank}.json")
        with open(shard, "w") as f:
            json.dump(result, f)

        # every shard must exist before rank 0 merges them
        if real_grid and dist and world > 1:
            torch.distributed.barrier()

        final = os.path.join(result_dir, f"{filename}.json")
        if rank == 0:
            merged, seen = [], set()
            for r in range(world):
                p = os.path.join(result_dir, f"{filename}_rank{r}.json")
                if not os.path.exists(p):
                    continue
                with open(p) as f:
                    part = json.load(f)
                for item in part:
                    if remove_duplicate:
                        key = item.get(remove_duplicate)
                        if key in seen:
                            continue
                        seen.add(key)
                    merged.append(item)
            with open(final, "w") as f:
                json.dump(merged, f)
            logging.info("result file saved to %s", final)
        return final
