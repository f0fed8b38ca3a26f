"""Data loading: batching, iteration, prefetch, sample preparation (port
of ``vlm_compression_tpu/datasets/loaders.py``).

``DataLoader`` batches a map-style item dataset through its ``collater``
in the JAX loader's index order (``numpy`` shuffle seeded with
seed + epoch, then the index list padded to a multiple of the world size
and sliced by rank, so every rank sees the same number of batches), and
an iterable-only one (the LAION stream) by draining it;
``IterLoader`` re-enters epochs; ``MultiIterLoader`` samples loaders by
ratio; ``PrefetchLoader`` prepares batches on a host thread, copying them
to the card from pinned memory without blocking; ``prepare_sample`` moves
a batch's arrays to a device.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from vlm_compression_tpu_torch.common.device import DeviceLike, resolve_device


def prepare_sample(samples: Dict[str, Any], device: DeviceLike = None,
                   pin: bool = False) -> Dict[str, Any]:
    """numpy arrays → tensors on ``device`` (the card unless the caller
    says otherwise; from pinned host memory and without blocking when
    ``pin`` and the device is the card); anything else (answers, ids)
    passes through for the host."""
    device = resolve_device(device)
    out = {}
    for k, v in samples.items():
        if isinstance(v, np.ndarray) and v.dtype != object:
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                if pin:
                    t = t.pin_memory()
                t = t.to(device, non_blocking=pin)
            out[k] = t
        else:
            out[k] = v
    return out


class DataLoader:
    """Map-style loader: shuffle, batch with ``dataset.collater``, drop or
    keep the ragged tail, shard over processes by rank."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 rank: int = 0, world_size: int = 1, collate_fn=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.rank = rank
        self.world_size = world_size
        self.collate_fn = collate_fn or getattr(dataset, "collater", None)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    @property
    def _streaming(self) -> bool:
        """An iterable-only dataset (no ``__len__``) batches by draining
        its iterator and shards itself over processes.  Its processes may
        see different numbers of batches, so it trains by iterations
        (``runner_iter``), not by epochs."""
        return not hasattr(self.dataset, "__len__")

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.world_size > 1:
            # pad to a multiple so every rank sees the same #batches
            pad = (-len(idx)) % self.world_size
            idx = np.concatenate([idx, idx[:pad]])
            idx = idx[self.rank:: self.world_size]
        return idx

    def __len__(self):
        if self._streaming:
            raise TypeError(
                "a streaming dataset has no length: train it by iterations "
                "(runner_iter, run.iters_per_inner_epoch) or set "
                "run.iters_per_epoch")
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        if self._streaming:
            buf = []
            for item in self.dataset:
                buf.append(item)
                if len(buf) == self.batch_size:
                    yield self.collate_fn(buf) if self.collate_fn else buf
                    buf = []
            if buf and not self.drop_last:
                yield self.collate_fn(buf) if self.collate_fn else buf
            return
        idx = self._indices()
        bs = self.batch_size
        stop = len(idx) - (len(idx) % bs) if self.drop_last else len(idx)
        for s in range(0, stop, bs):
            items = [self.dataset[int(i)] for i in idx[s: s + bs]]
            yield self.collate_fn(items) if self.collate_fn else items


class IterLoader:
    """Infinite iterator that re-enters epochs and bumps ``set_epoch``."""

    def __init__(self, loader, use_distributed: bool = False):
        self._loader = loader
        self._iter = iter(loader)
        self._epoch = 0

    @property
    def epoch(self):
        return self._epoch

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._iter)
        except StopIteration:
            self._epoch += 1
            if hasattr(self._loader, "set_epoch"):
                self._loader.set_epoch(self._epoch)
            self._iter = iter(self._loader)
            return next(self._iter)


class MultiIterLoader:
    """Sample among loaders with the given ratios."""

    def __init__(self, loaders: Sequence,
                 ratios: Optional[Sequence[float]] = None, seed: int = 0):
        self.loaders = [ld if isinstance(ld, IterLoader) else IterLoader(ld)
                        for ld in loaders]
        r = np.asarray(ratios if ratios is not None
                       else [1.0] * len(loaders), np.float64)
        self.probs = r / r.sum()
        self.rng = np.random.default_rng(seed)

    def __next__(self):
        i = int(self.rng.choice(len(self.loaders), p=self.probs))
        return next(self.loaders[i])

    def __iter__(self):
        return self


class PrefetchLoader:
    """Overlap host batch preparation and the copy to the card with the
    card's work: a host thread keeps ``depth`` prepared batches queued
    (pinned and copied without blocking on the card).  An error in the
    thread is raised where the batch would have come."""

    def __init__(self, loader, device: DeviceLike = None, depth: int = 2):
        self.loader = loader
        self.device = resolve_device(device)
        self.depth = depth

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        errors: List[BaseException] = []

        def work():
            try:
                for b in self.loader:
                    q.put(prepare_sample(b, self.device, pin=True))
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors.append(exc)
            finally:
                q.put(end)

        t = threading.Thread(target=work, daemon=True)
        t.start()
        while True:
            b = q.get()
            if b is end:
                break
            yield b
        t.join()
        if errors:
            raise errors[0]


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._starts = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._starts[-1])

    def __getitem__(self, i):
        d = int(np.searchsorted(self._starts, i, side="right") - 1)
        return self.datasets[d][i - int(self._starts[d])]

    def collater(self, items):
        return self.datasets[0].collater(items)


def concat_datasets(datasets: List) -> ConcatDataset:
    return ConcatDataset(datasets)


def reorg_datasets_by_split(datasets: Dict[str, Dict[str, Any]]
                            ) -> Dict[str, List]:
    """{name: {split: ds}} → {split: [ds, ...]}"""
    out: Dict[str, List] = {}
    for _, by_split in datasets.items():
        for split, ds in by_split.items():
            out.setdefault(split, []).append(ds)
    return out
