"""Training telemetry: windowed meters and the step logger.

Counterpart of ``pytorch_retinanet_tpu/utils/metrics.py``'s
``SmoothedValue`` and ``MetricLogger`` (the torchvision-style meters the
reference keeps in ``utils/coco/detection_utils.py``), the device memory
telemetry and the profiler hook, on ``torch.cuda`` and ``torch.profiler``.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


class SmoothedValue:
    """Scalar meter: statistics over the last `window_size` updates (a ring
    buffer) plus lifetime totals."""

    __slots__ = ("_ring", "_cursor", "_filled", "_lifetime_sum", "_lifetime_n", "fmt")

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} (avg {global_avg:.4f})"):
        self._ring = np.zeros(max(1, window_size), np.float64)
        self._cursor = 0
        self._filled = 0
        self._lifetime_sum = 0.0
        self._lifetime_n = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self._ring[self._cursor] = value
        self._cursor = (self._cursor + 1) % self._ring.size
        self._filled = min(self._filled + 1, self._ring.size)
        self._lifetime_sum += float(value) * n
        self._lifetime_n += n

    def _window(self) -> np.ndarray:
        return self._ring[: self._filled]

    @property
    def window(self) -> List[float]:
        """The window's values, oldest first."""
        if self._filled < self._ring.size:
            return self._ring[: self._filled].tolist()
        return np.roll(self._ring, -self._cursor).tolist()

    @property
    def median(self) -> float:
        w = self._window()
        return float(np.median(w)) if w.size else 0.0

    @property
    def avg(self) -> float:
        w = self._window()
        return float(w.mean()) if w.size else 0.0

    @property
    def global_avg(self) -> float:
        return self._lifetime_sum / max(self._lifetime_n, 1)

    @property
    def max(self) -> float:
        w = self._window()
        return float(w.max()) if w.size else 0.0

    @property
    def value(self) -> float:
        """The most recent update."""
        if not self._filled:
            return 0.0
        return float(self._ring[(self._cursor - 1) % self._ring.size])

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg,
                               max=self.max, value=self.value)


class MetricLogger:
    """Iteration logger with meters, step and data times and an ETA."""

    def __init__(self, delimiter: str = "  ", print_freq: int = 50):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.print_freq = print_freq

    def update(self, **kwargs: float) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, attr: str) -> SmoothedValue:
        if attr in self.meters:
            return self.meters[attr]
        raise AttributeError(attr)

    def __str__(self) -> str:
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def log_every(self, iterable: Iterable, header: str = "",
                  total: Optional[int] = None) -> Iterator:
        total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        start = end = time.time()
        for i, obj in enumerate(iterable):
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            end = time.time()
            if i % self.print_freq == 0 or (total and i == total - 1):
                eta = (str(datetime.timedelta(seconds=int(iter_time.global_avg * (total - i))))
                       if total else "?")
                logger.info("%s [%d%s] eta: %s %s time: %s data: %s", header, i,
                            f"/{total}" if total else "", eta, str(self), str(iter_time),
                            str(data_time))
        logger.info("%s done in %s", header,
                    str(datetime.timedelta(seconds=int(time.time() - start))))


def device_memory_stats() -> Dict[str, float]:
    """Memory allocated on each CUDA device and its peak, in MiB, under
    ``cuda{i}_mb`` and ``cuda{i}_peak_mb``; {} without CUDA."""
    import torch

    out: Dict[str, float] = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda{i}_mb"] = round(torch.cuda.memory_allocated(i) / 2**20, 1)
        out[f"cuda{i}_peak_mb"] = round(torch.cuda.max_memory_allocated(i) / 2**20, 1)
    return out


class ProfilerHook:
    """A ``torch.profiler`` trace over a step range, written under
    ``log_dir`` as a Chrome trace: it starts after step ``start_step`` and
    stops at ``start_step + num_steps``, or at :meth:`close`. Without a
    ``log_dir`` it does nothing."""

    def __init__(self, log_dir: Optional[str], start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.trace_path: Optional[str] = None
        self._prof = None

    def step(self, step: int) -> None:
        if not self.log_dir:
            return
        if step == self.start_step and self._prof is None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
        elif step >= self.stop_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, f"trace_steps_{self.start_step + 1}-{self.stop_step}.json")
        prof.export_chrome_trace(self.trace_path)
        logger.info("profiler trace written to %s", self.trace_path)
