"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (the directory that holds ``BENCHMARK.json``).
The cell names a configuration and a traffic mix; the traffic's ``driver``
(``predict`` or ``train``, under ``benchmark/rnbench/``) builds the weights
and inputs from the seed, warms up, measures for ``--seconds``, and checks
what the timed path produced against the plain reference. With
``--trace 0`` the result holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read by ``benchmark/metrics/<name>.py``
from a profiler window, the benchmark's spans and counters. The numbers
that decide ``correct`` come last, each beside its limit, on standard error
and in the result line's ``checks``.

Exit codes: 0 with a result line; 2 without a card (or too few); 3 if JAX or
the JAX package was loaded; 1 on any error.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_retinanet_tpu")


class Context:
    """What a driver gets: the cell's files, the run's arguments, the device,
    the benchmark's `spec` and the configuration's trunk family."""

    def __init__(self, cfg, traffic, args, device, t_start, spec):
        import torch

        self.cfg, self.traffic = cfg, traffic
        self.spec, self.family = spec, spec.family(cfg)
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device = device
        self.t_start = t_start
        self._torch = torch

    def sync(self):
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return int(self._torch.cuda.max_memory_allocated(self.device))

    def free(self):
        gc.collect()
        if self.device.type == "cuda":
            self._torch.cuda.empty_cache()


def loaded_forbidden(names) -> list:
    """Top-level module names (before the first dot, compared whole) that
    are JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e300


def main(argv=None, root: Path = HERE.parent, require_cuda: bool = True, rank_hook=None) -> int:
    """One run; `require_cuda` False and `rank_hook` (``"module:function"``,
    called in each spawned rank first) serve the CPU tests alone."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(root).resolve()
    for p in (str(HERE), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)
    # Every build and kernel cache of the program stays inside the checkout.
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "build" / "torch_extensions"))

    import pytorch_retinanet_tpu_torch  # noqa: F401  (the system under test, at the root)
    from rnbench import predict, train
    from rnbench.spec import Spec

    spec = Spec(root)
    cell = spec.cell(args.workload)
    import torch

    if require_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"{cell['name']} needs {cell['chips']} CUDA card(s); this machine has {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        # The host's few cores drive the card: one intra-op thread keeps the
        # process from competing with itself (predict_img_s spread over 7%
        # run to run with the default threads, 2% with one, in one call).
        torch.set_num_threads(1)
    else:
        device = torch.device("cpu")
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    if int(traffic.get("world", 1)) != int(cell["chips"]):
        raise ValueError(f"{cell['name']}: traffic {cell['traffic']} runs {traffic.get('world', 1)} "
                         f"ranks, the cell asks for {cell['chips']} chips")
    driver = {"predict": predict, "train": train}[traffic["driver"]]
    ctx = Context(cfg, traffic, args, device, T_START, spec)
    ctx.rank_hook = rank_hook
    out = driver.run(ctx)

    run = {"e2e": out["e2e"], "trace": out.get("trace") or {}, "spans": out.get("spans") or {},
           "counters": out.get("counters") or {}, "cfg": cfg, "traffic": traffic,
           "batch": out["batch"], "bucket": out["bucket"], "world": int(cell["chips"]),
           "root": str(root), "family": ctx.family,
           "device_name": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"}
    metrics = {}
    if args.trace:
        for m in spec.per_layer(cell):
            value = spec.reader(m).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec.end_to_end(cell):
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}

    limits = spec.limits(cell)
    # A number that the cell's limits leave out is read, and not compared:
    # it has no reading that a limit could lie below (PERF.md).
    checks = {k: {"value": _finite(float(out["checks"][k])), "limit": limits[k]}
              for k in limits if k in out["checks"]}
    correct = (set(limits) <= set(out["checks"])
               and all(math.isfinite(out["checks"][k]) and out["checks"][k] <= limits[k]
                       for k in limits))
    bad = loaded_forbidden(list(sys.modules) + out.get("rank_modules", []))
    if bad:
        print(f"loaded after the window: {bad}", file=sys.stderr)
        return 3
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": run["device_name"],
           "count": int(cell["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if args.trace:
        if not run["trace"].get("busy_s"):
            print("the traced window recorded no device time", file=sys.stderr)
            return 1
        dev["busy_s"] = run["trace"]["busy_s"]
        dev["window_s"] = run["trace"]["window_s"]
        result["breakdown"] = {"device_ops": run["trace"]["device_ops"],
                               "idle_gaps": run["trace"]["idle_gaps"]}
    result["checks"] = checks
    for line in out.get("detail", []):
        print(line, file=sys.stderr)
    for k in sorted(set(out["checks"]) - set(limits)):
        print(f"read {k} {out['checks'][k]!r}, not compared", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
