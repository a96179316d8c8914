"""Device traces and the benchmark's own spans.

:class:`Profiled` runs whole calls inside one ``torch.profiler`` window and
reduces its events to what the per-layer readers take: the device's busy
seconds (the union of kernel, copy and set intervals) over the window's
wall, each device operation's seconds and count by name, and the longest
idle gaps with the innermost host operation that was running when each
began. A window that recorded nothing on the device is run again, up to
three in all (the card's tracer now and then returns an empty one).

:func:`cuda_ms` times a stage with CUDA events.
"""

from __future__ import annotations

import re
import time
from typing import Callable, Dict, List

import torch

from .yardstick import union_s

WINDOWS = 3
TOP = 10


def _events(prof):
    """(name, on_device, start_s, end_s) of every recorded event."""
    out = []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False):
            continue  # a host range mirrored on the device's timeline, not device work
        on_device = e.device_type == torch.autograd.DeviceType.CUDA
        out.append((e.name, on_device, e.time_range.start / 1e6, e.time_range.end / 1e6))
    return out


def _short(name: str) -> str:
    m = re.search(r"\b(\w+_kernel|nccl\w+|Memcpy \w+|Memset \w*)", name)
    return m.group(1) if m else name[:80]


def reduce_events(events, wall_s: float, calls: int) -> Dict:
    """The trace's summary for the readers and the result's ``breakdown``."""
    dev = [(s, e, n) for n, on, s, e in events if on]
    host = [(s, e, n) for n, on, s, e in events if not on]
    busy = union_s((s, e) for s, e, _ in dev)
    ops: Dict[str, List[float]] = {}
    for s, e, n in dev:
        ops.setdefault(_short(n), []).append(e - s)
    gaps = []
    end = None
    for s, e, _ in sorted(dev):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = []
    for g0, g1 in gaps[:TOP]:
        running = [(e - s, n) for s, e, n in host if s <= g0 <= e]
        idle.append([min(running)[1] if running else "no host op", g1 - g0])
    return {
        "busy_s": busy, "window_s": wall_s, "calls": calls,
        "ops": {k: (sum(v), len(v)) for k, v in ops.items()},
        "device_ops": sorted(([k, sum(v)] for k, v in ops.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": idle,
    }


class Profiled:
    """``run(fn, calls)``: `calls` calls of `fn` in one profiler window."""

    def run(self, fn: Callable[[], object], calls: int, sync: Callable[[], None]) -> Dict:
        from torch.profiler import ProfilerActivity, profile

        for _ in range(WINDOWS):
            sync()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(calls):
                    fn()
                sync()
                wall = time.perf_counter() - t0
            events = _events(prof)
            if any(on for _, on, _, _ in events):
                return reduce_events(events, wall, calls)
        raise RuntimeError("the profiler recorded no device activity in 3 windows")


class Window:
    """A profiler window opened and closed from outside a loop (the
    training loader opens it at one fetch and closes it at a later one)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._t0 = 0.0

    def start(self) -> None:
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self, calls: int) -> Dict:
        wall = time.perf_counter() - self._t0
        self._prof.stop()
        events = _events(self._prof)
        if not any(on for _, on, _, _ in events):
            return {}
        return reduce_events(events, wall, calls)


def cuda_ms(fn: Callable[[], object], reps: int) -> List[float]:
    """Each of `reps` calls of `fn` timed by CUDA events (after one untimed call)."""
    fn()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out
