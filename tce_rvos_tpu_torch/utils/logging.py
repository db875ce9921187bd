"""Metric logging (counterpart of ``tce_rvos_tpu/utils/logging.py``):
``SmoothedValue`` (windowed median and average, global average) and
``MetricLogger.log_every`` (progress lines with ETA and iteration and data
times), printed by rank 0 only in a ``torch.distributed`` world."""

from __future__ import annotations

import datetime
import time
from collections import defaultdict, deque
from typing import Dict

from tce_rvos_tpu_torch.parallel.collectives import is_main_process


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

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
            max=self.max, value=self.value,
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr):
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def add_meter(self, name: str, meter: SmoothedValue):
        self.meters[name] = meter

    def log_every(self, iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        end = time.time()
        # kept on the logger: seconds per iteration, and of it the wait for data
        iter_time = self.iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = self.data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 and is_main_process():
                if total:
                    eta = datetime.timedelta(seconds=int(iter_time.global_avg * (total - i)))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} "
                          f"time: {iter_time} data: {data_time}", flush=True)
                else:
                    print(f"{header} [{i}] {self} time: {iter_time} data: {data_time}",
                          flush=True)
            i += 1
            end = time.time()
        if is_main_process():
            elapsed = str(datetime.timedelta(seconds=int(time.time() - start)))
            print(f"{header} Total time: {elapsed}", flush=True)
