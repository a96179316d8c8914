"""The program's own spans and counters, read in a traced run.

The readers of the metrics that the program's tracer feeds
(``pytorch_retinanet_tpu_torch.utils.metrics``: ``span``, ``count``,
``drain``) call :func:`program_pass`, which runs once a run, after every
measurement of ``predict.py`` or ``train.py`` and every reader before them. It builds the
cell's workload again, weights and inputs from :data:`PASS_SEED` (the pass
reads times and counts, not answers), warms it up as the run did, and
with the tracer on runs

- predict: :data:`PASS_CALLS` calls of ``Retinanet.predict``, cycling
  through the pool (the spans' and counters' metrics), then as many in one
  ``torch.profiler`` window (the trace's metrics; apart, since the
  profiler's cost a launch would sit in the host spans);
- training: :data:`PASS_STEPS` steps of a ``Trainer.fit`` set up as the
  run's (``train._Job``), after its warm-up, in every rank (spawned by
  ``train._spawn``); rank 0's records are the run's.

A program without the tracer gives None, and so do its readers.

:func:`attribute` reduces the predict window's profiler events on the
trace's own clock: the program's spans as host user annotations, the
device's intervals and their idle gaps, and the runtime calls that launch
a kernel or wait for the device inside each ``predict`` span.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from . import train

PASS_SEED = 0
PASS_CALLS = 3
PASS_STEPS = 3
WINDOWS = 3  # profiler windows tried before giving up on an empty one
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
         "cudaMemcpy2D", "cudaMemcpy3D", "cuMemcpyDtoH", "cuMemcpyHtoD", "cuCtxSynchronize",
         "cuStreamSynchronize")
PREDICT_PARTS = ("predict.front", "predict.forward", "predict.postprocess", "predict.readback")

_last: Tuple[object, Optional[Dict]] = (None, None)


def program_pass(run: Dict) -> Optional[Dict]:
    """The pass's result for `run` (made at the first call): ``records``
    (the tracer's drain), ``calls`` or ``steps``, and for predict on a
    card ``window`` (:func:`attribute`) and ``window_records`` (the
    profiled calls' drain); None without the tracer."""
    global _last
    if _last[0] is not run:
        _last = (run, _run_pass(run))
    return _last[1]


def _tracer():
    try:
        from pytorch_retinanet_tpu_torch.utils import metrics
    except ImportError:
        return None
    return metrics if all(hasattr(metrics, f) for f in ("span", "tracing", "drain")) else None


def _run_pass(run: Dict) -> Optional[Dict]:
    tracer = _tracer()
    if tracer is None:
        return None
    device = torch.device("cpu") if run["device_name"] == "cpu" else torch.device("cuda", 0)
    if run["traffic"]["driver"] == "predict":
        out = _predict_pass(run, tracer, device)
    else:
        out = _train_pass(run, device)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    print(_summary(out), file=sys.stderr)
    return out


# --------------------------------------------------------------------------- #
# Predict
# --------------------------------------------------------------------------- #
def _predict_pass(run: Dict, tracer, device) -> Dict:
    from . import predict

    net, _ = predict.build(run["cfg"], run["traffic"], PASS_SEED, device, run["family"])
    calls = predict.make_pool(run["traffic"], PASS_SEED, device)
    for images in calls:
        net.predict(images)

    def pass_calls():
        for i in range(PASS_CALLS):
            net.predict(calls[i % len(calls)])

    out = {"calls": PASS_CALLS}
    tracer.drain()
    with tracer.tracing():
        pass_calls()
    out["records"] = tracer.drain()
    if device.type != "cuda":
        return out
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WINDOWS):
        torch.cuda.synchronize(device)
        with tracer.tracing():
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                pass_calls()
                torch.cuda.synchronize(device)
        out["window_records"] = tracer.drain()
        out["window"] = attribute(profiler_events(prof), "predict")
        if out["window"]:
            break
    return out


def profiler_events(prof) -> List[Tuple[str, str, float, float]]:
    """(name, kind, start_s, end_s) of a window's events; kind is
    ``annotation`` (a host user annotation: a program span), ``device``
    (a kernel, copy or set on the card; the annotations the profiler
    mirrors onto the device's timeline are left out) or ``host``."""
    out = []
    for e in prof.events():
        user = getattr(e, "is_user_annotation", False)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if user:
                continue
            kind = "device"
        else:
            kind = "annotation" if user else "host"
        out.append((e.name, kind, e.time_range.start / 1e6, e.time_range.end / 1e6))
    return out


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap_s(a: Sequence[Tuple[float, float]], b: Sequence[Tuple[float, float]]) -> float:
    """Seconds two unions of intervals (each sorted and disjoint) share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def attribute(events: Sequence[Tuple[str, str, float, float]], root: str) -> Dict:
    """The window from the first `root` span's start to the last one's end:
    its seconds, its idle seconds (no device interval running), the idle
    seconds inside each span name, each name's number of annotations, and
    per `root` span the runtime calls that launch a kernel
    (``cudaLaunchKernel``, ``cuLaunchKernel*``) and that wait for the
    device (:data:`SYNCS`). {} when the window has no `root` span or no
    device interval."""
    spans: Dict[str, List[Tuple[float, float]]] = {}
    for name, kind, s, e in events:
        if kind == "annotation":
            spans.setdefault(name, []).append((s, e))
    roots = sorted(spans.get(root, []))
    device = [(s, e) for _, kind, s, e in events if kind == "device"]
    if not roots or not device:
        return {}
    w0, w1 = roots[0][0], max(e for _, e in roots)
    idle, at = [], w0
    for s, e in _union(device):
        if s > at:
            idle.append((at, min(s, w1)))
        at = max(at, e)
        if at >= w1:
            break
    if at < w1:
        idle.append((at, w1))
    idle = [(s, e) for s, e in idle if e > s]
    launches = [t for name, kind, t, _ in events if kind == "host" and name.startswith(LAUNCHES)]
    syncs = [t for name, kind, t, _ in events if kind == "host" and name in SYNCS]
    return {"window_s": w1 - w0, "idle_s": sum(e - s for s, e in idle),
            "idle_in": {name: _overlap_s(idle, _union(iv)) for name, iv in spans.items()},
            "annotations": {name: len(iv) for name, iv in spans.items()},
            "launches": [sum(s <= t <= e for t in launches) for s, e in roots],
            "syncs": [sum(s <= t <= e for t in syncs) for s, e in roots]}


# --------------------------------------------------------------------------- #
# Training
# --------------------------------------------------------------------------- #
class _PassDone(Exception):
    """Raised by :meth:`_PassJob.feed` once the traced steps are recorded:
    it ends the fit and, with it, ``_Job.run`` before the reference checks
    that follow the fit there, which are the run's and not the pass's."""


class _PassJob(train._Job):
    """``train._Job``'s set-up and fit, fed its warm-up steps and then
    :data:`PASS_STEPS` steps with the program's tracer on."""

    def feed(self):
        from pytorch_retinanet_tpu_torch.utils import metrics as tracer

        batches, warm = self.batches, int(self.p["traffic"]["warmup_steps"])
        for k in range(warm):
            yield batches[k % len(batches)]
        self.sync()
        self.barrier()
        tracer.drain()
        t0 = time.perf_counter()
        with tracer.tracing():
            for j in range(PASS_STEPS):
                yield batches[(warm + j) % len(batches)]
            self.sync()
            self.barrier()
        self.result = {"window_s": time.perf_counter() - t0, "steps": PASS_STEPS,
                       "records": tracer.drain()}
        raise _PassDone

    def run(self) -> Dict:
        try:
            super().run()
        except _PassDone:
            pass
        return self.result if self.rank == 0 else {}


def _pass_ranks() -> None:
    """``train._rank_main``'s hook in each rank the pass spawns: the rank
    runs a :class:`_PassJob` in place of the run's job."""
    train._Job = _PassJob


def _train_pass(run: Dict, device) -> Dict:
    params = {"cfg": run["cfg"], "traffic": run["traffic"], "root": run["root"], "seed": PASS_SEED,
              "trace": False, "device_type": device.type, "rank_hook": f"{__name__}:_pass_ranks"}
    world = int(run["world"])
    if world == 1:
        return _PassJob(params, 0, 1, device, None).run()
    return train._spawn(params, world)[0]


# --------------------------------------------------------------------------- #
# What the readers take
# --------------------------------------------------------------------------- #
def per_call(result: Dict, name: str, field: str = "host_ms") -> List[float]:
    """`field` of the `name` spans summed within each call (in call order)."""
    sums: Dict[int, float] = {}
    for s in result["records"]["spans"]:
        if s["name"] == name and s[field] is not None:
            sums[s["call"]] = sums.get(s["call"], 0.0) + s[field]
    return [sums[c] for c in sorted(sums)]


def median_ms(run: Dict, name: str, field: str = "host_ms") -> Optional[float]:
    """The median over the pass's calls or steps of `name`'s `field`."""
    result = program_pass(run)
    values = per_call(result, name, field) if result else []
    return statistics.median(values) if values else None


def _summary(result: Dict) -> str:
    """One line for the run's standard error: what the pass saw besides its
    metrics (each span's share of the call or step, the idle outside the
    parts, the syncs the counter and the runtime saw)."""
    if "calls" in result:
        def cover(records):
            r = {"records": records}
            parts = [sum(v) for v in zip(*(per_call(r, p) for p in PREDICT_PARTS))]
            return [round(p / c, 4) for p, c in zip(parts, per_call(r, "predict"))]

        line = {"pass": "predict", "calls": result["calls"], "parts_cover": cover(result["records"]),
                "host_syncs_per_call": result["records"]["counters"].get("host_syncs", 0) / result["calls"],
                "dropped": result["records"]["dropped"]}
        w = result.get("window")
        if w:
            named: Dict[str, int] = {}
            for sp in result["window_records"]["spans"]:
                named[sp["name"]] = named.get(sp["name"], 0) + 1
            line.update(profiled_parts_cover=cover(result["window_records"]),
                        all_annotated=named == w["annotations"], runtime_syncs=w["syncs"],
                        launches=w["launches"], idle_s=round(w["idle_s"], 6),
                        idle_in={k: round(v / w["idle_s"], 4) for k, v in w["idle_in"].items()
                                 if w["idle_s"]})
        return "program pass " + str(line)
    steps = result["steps"]
    device = [sum(per_call(result, n, "device_ms")) for n in
              ("train.forward", "train.loss", "train.backward", "train.optimizer")]
    host = [sum(per_call(result, n)) for n in ("train.fetch", "train.upload")]
    fetches = len(per_call(result, "train.fetch"))
    step_ms = 1e3 * result["window_s"] / steps
    # The first step's fetch opens before the tracer is on: the fetches
    # seen stand for the steps'.
    cover = (sum(device) / steps + host[0] / max(fetches, 1) + host[1] / steps) / step_ms
    return "program pass " + str({"pass": "train", "steps": steps, "step_ms": round(step_ms, 3),
                                  "parts_cover": round(cover, 4), "fetches": fetches,
                                  "dropped": result["records"]["dropped"]})
