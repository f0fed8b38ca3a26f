"""MetricLogger / SmoothedValue with a sum over processes (port of
``vlm_compression_tpu/common/logger.py``): windowed medians and averages,
global averages synced over the process group, an iteration logger with
ETA and the card's peak memory."""

from __future__ import annotations

import datetime
import logging
import time
from collections import defaultdict, deque

import torch

from vlm_compression_tpu_torch.common import dist


class SmoothedValue:
    """Track a series of values; expose window-smoothed and global stats."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(float(value))
        self.count += n
        self.total += float(value) * n

    def synchronize_between_processes(self):
        """Sum count and total over the processes."""
        self.count = int(dist.all_reduce_scalar(self.count, "sum"))
        self.total = dist.all_reduce_scalar(self.total, "sum")

    @property
    def median(self):
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self):
        return sum(self.deque) / len(self.deque) if self.deque else 0.0

    @property
    def global_avg(self):
        return self.total / max(self.count, 1)

    @property
    def max(self):
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self):
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg,
            max=self.max, value=self.value)


def device_memory_mb() -> float:
    """The card's peak allocated memory in MB (``torch.cuda``); 0 without
    a card."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def add_meter(self, name, meter):
        self.meters[name] = meter

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def __str__(self):
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    @property
    def global_avg(self):
        return self.delimiter.join(
            f"{n}: {m.global_avg:.4f}" for n, m in self.meters.items())

    def log_every(self, iterable, print_freq, header=""):
        """Yield from iterable, logging time/ETA/memory every print_freq."""
        i = 0
        start_time = time.time()
        end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                if total is not None:
                    eta = datetime.timedelta(
                        seconds=int(iter_time.global_avg * (total - i)))
                    eta_str = f"eta: {eta}  "
                    frac = f"[{i}/{total}]"
                else:
                    eta_str, frac = "", f"[{i}]"
                logging.info(
                    f"{header} {frac}  {eta_str}{self}  time: {iter_time}  "
                    f"data: {data_time}  mem: {device_memory_mb():.0f}MB")
            i += 1
            end = time.time()
        total_time = time.time() - start_time
        logging.info(f"{header} Total time: "
                     f"{datetime.timedelta(seconds=int(total_time))}")


def setup_logger(level=logging.INFO):
    """INFO logging on process 0, warnings elsewhere."""
    logging.basicConfig(
        level=level if dist.is_main_process() else logging.WARNING,
        format="%(asctime)s [%(levelname)s] %(message)s")
