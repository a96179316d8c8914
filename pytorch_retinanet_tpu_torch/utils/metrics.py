"""Telemetry: windowed meters, the step logger, spans and counters.

Counterpart of ``pytorch_retinanet_tpu/utils/metrics.py``'s
``SmoothedValue`` and ``MetricLogger`` (the torchvision-style meters the
reference keeps in ``utils/coco/detection_utils.py``), the device memory
telemetry and the profiler hook, on ``torch.cuda`` and ``torch.profiler``.

The tracer (:func:`span`, :func:`count`, :func:`count_syncs`,
:func:`set_tracing`, :func:`tracing`, :func:`drain`) records the layers of
``Retinanet.predict`` and of a training step. It is off unless turned on;
off, :func:`span` is one flag test that returns a shared no-op context and
:func:`count` or :func:`count_syncs` one flag test. :class:`ProfilerHook` turns it on for its window, so the spans
sit in its Chrome trace as user annotations.
"""

from __future__ import annotations

import contextlib
import datetime
import itertools
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

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
                  total: Optional[int] = None, fetch_span: str = "loader.fetch") -> Iterator:
        """Yield `iterable`'s items, timing the wait for each (``data``) and
        each iteration (``time``) on ``time.perf_counter``. The wait is one
        reading with two readers: the ``data`` meter and, when tracing is
        on, the `fetch_span` span."""
        total = total if total is not None else (
            len(iterable) if hasattr(iterable, "__len__") else None)
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        items = iter(iterable)
        start = end = time.perf_counter()
        for i in itertools.count():
            with _Span(fetch_span, None, _on) as fetch:
                obj = next(items, _END)
            if obj is _END:
                break
            data_time.update(fetch.seconds)
            yield obj
            now = time.perf_counter()
            iter_time.update(now - end)
            end = now
            if i % self.print_freq == 0 or (total and i == total - 1):
                eta = (str(datetime.timedelta(seconds=int(iter_time.global_avg * (total - i))))
                       if total else "?")
                logger.info("%s [%d%s] eta: %s %s time: %s data: %s", header, i,
                            f"/{total}" if total else "", eta, str(self), str(iter_time),
                            str(data_time))
        logger.info("%s done in %s", header,
                    str(datetime.timedelta(seconds=int(time.perf_counter() - start))))


# --------------------------------------------------------------------------- #
# Spans and counters
# --------------------------------------------------------------------------- #
TRACE_CAP = 200_000  # records held between drains; the rest are dropped and counted

_on = False  # the one flag that span() and count() test
_END = object()
_NO_SPAN = contextlib.nullcontext()
SYNC_DEVICES = ("cuda",)  # on the CPU an upload or a read waits for nothing


class _Records:
    """What tracing gathered since the last drain, and the ids it hands out."""

    def __init__(self):
        self.lock = threading.Lock()
        self.spans: List["_Span"] = []
        self.counters: Dict[str, Any] = {}
        self.dropped = 0
        self.ids = itertools.count(1)
        self.calls = itertools.count(1)
        self.open = threading.local()  # each thread's stack of open spans

    def stack(self) -> List["_Span"]:
        s = getattr(self.open, "stack", None)
        if s is None:
            s = self.open.stack = []
        return s

    def add(self, s: "_Span") -> None:
        with self.lock:
            if len(self.spans) < TRACE_CAP:
                self.spans.append(s)
            else:
                self.dropped += 1

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def take(self):
        with self.lock:
            out = self.spans, self.counters, self.dropped
            self.spans, self.counters, self.dropped = [], {}, 0
        return out


_records = _Records()


class _Span:
    """One span: host start and end on ``perf_counter_ns``, its parent, its
    call (the root's: every span of one predict call or training step
    shares it), a CUDA event pair on `device`'s current stream for a CUDA
    `device`, and a ``record_function`` range while a profiler is on.
    With `recorded` false it is only a stopwatch (``seconds``)."""

    __slots__ = ("name", "device", "recorded", "id", "parent", "call", "t0", "t1", "_events",
                 "_range")

    def __init__(self, name: str, device: Optional[torch.device], recorded: bool = True):
        self.name, self.device, self.recorded = name, device, recorded
        self._events = self._range = None

    def __enter__(self) -> "_Span":
        if self.recorded:
            stack = _records.stack()
            up = stack[-1] if stack else None
            self.id = next(_records.ids)
            self.parent = None if up is None else up.id
            self.call = next(_records.calls) if up is None else up.call
            stack.append(self)
            if torch._C._autograd._profiler_enabled():
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
            if self.device is not None and self.device.type == "cuda":
                self._events = (torch.cuda.Event(enable_timing=True),
                                torch.cuda.Event(enable_timing=True))
                self._events[0].record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.recorded:
            if self._events is not None:
                self._events[1].record(torch.cuda.current_stream(self.device))
            if self._range is not None:
                self._range.__exit__(*exc)
            stack = _records.stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:
                stack.remove(self)
            if _on:  # a span that outlived its tracing is not kept
                _records.add(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def record(self) -> Dict[str, Any]:
        host_ms = (self.t1 - self.t0) / 1e6
        if self._events is not None:
            device_ms = self._events[0].elapsed_time(self._events[1])
        else:
            device_ms = None if self.device is None else host_ms
        return {"name": self.name, "id": self.id, "parent": self.parent, "call": self.call,
                "start_ns": self.t0, "end_ns": self.t1, "host_ms": host_ms, "device_ms": device_ms}


def span(name: str, device: Optional[torch.device] = None):
    """``with span(name):`` records the block when tracing is on. With a
    `device`, the span also times the block on it: CUDA events on its
    current stream, read at :func:`drain` (nothing here waits for the
    device); on the CPU, the host clock. Off: one flag test and a shared
    no-op context."""
    if not _on:
        return _NO_SPAN
    return _Span(name, device)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` when tracing is on."""
    if _on:
        _records.count(name, n)


def count_syncs(device, n: int = 1) -> None:
    """Add `n` to ``host_syncs`` when tracing is on and `device`, the one a
    pageable upload goes to or a read comes from, makes the host wait for
    it: a device of a type in :data:`SYNC_DEVICES`."""
    if _on and torch.device(device).type in SYNC_DEVICES:
        _records.count("host_syncs", n)


def set_tracing(on: bool) -> bool:
    """Turn tracing on or off; returns whether it was on."""
    global _on
    was, _on = _on, bool(on)
    return was


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Tracing on inside the block, and as it was after."""
    was = set_tracing(True)
    try:
        yield
    finally:
        set_tracing(was)


def drain() -> Dict[str, Any]:
    """What tracing recorded since the last drain, which it clears:
    ``{"spans": [...], "counters": {name: total}, "dropped": n}``. A span is
    a dict of ``name``, ``id``, ``parent`` (its parent's id or None),
    ``call``, ``start_ns`` / ``end_ns`` (``perf_counter_ns``), ``host_ms``
    and ``device_ms`` (None for a host span; a device span's CUDA events,
    read after one synchronize of each card they ran on, or its host ms on
    the CPU), in the order the spans ended."""
    spans, counters, dropped = _records.take()
    for card in {s.device for s in spans if s._events is not None}:
        torch.cuda.synchronize(card)
    return {"spans": [s.record() for s in spans], "counters": counters, "dropped": dropped}


def device_memory_stats() -> Dict[str, float]:
    """Memory allocated on each CUDA device and its peak, in MiB, under
    ``cuda{i}_mb`` and ``cuda{i}_peak_mb``; {} without CUDA."""
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
    stops at ``start_step + num_steps``, or at :meth:`close`. Tracing is on
    for the window (as it was after), so the trace holds the spans as user
    annotations; their records stay for :func:`drain`. Without a
    ``log_dir`` it does nothing."""

    def __init__(self, log_dir: Optional[str], start_step: int = 10, num_steps: int = 5):
        self.log_dir = log_dir
        self.start_step = start_step
        self.stop_step = start_step + num_steps
        self.trace_path: Optional[str] = None
        self._prof = None
        self._was_tracing = False

    def step(self, step: int) -> None:
        if not self.log_dir:
            return
        if step == self.start_step and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._was_tracing = set_tracing(True)
        elif step >= self.stop_step and self._prof is not None:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        set_tracing(self._was_tracing)
        prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(
            self.log_dir, f"trace_steps_{self.start_step + 1}-{self.stop_step}.json")
        prof.export_chrome_trace(self.trace_path)
        logger.info("profiler trace written to %s", self.trace_path)
