"""The control of a cell's comparison, and its planted faults, at the cell's
own size: what the numbers that decide ``correct`` read when the plain
reference, computed in a lower precision or broken on purpose, stands in
the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--device cuda]

Per seed it prints one JSON line: the cell, the seed, and for each arm
(``fp8``: convolution inputs and weights rounded to float8 e4m3, the
precision below the configuration's bf16, and in training each
convolution's output too, and its gradient to float8 e5m2, as the program
holds its activations and gradients in bf16; for predict cells also the
reference's NMS broken: ``keep_all`` keeps every valid candidate,
``one_per_class`` the best of each class, ``empty`` nothing, and
``lowest_k`` selects the lowest candidates across the levels; for training
cells ``half``: each batch's loss over its first half alone; for a cell of
more than one rank, ``no_exchange``: rank 0's own gradient, not the ranks'
mean) the numbers the cell compares. The program is not run: a
data-parallel cell's ranks are computed one after another on one card,
their gradients averaged as the all-reduce averages them. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def predict_arms(cfg, traffic, seed, device):
    from rnbench import compare, predict
    from rnbench import reference as R

    m = cfg["model"]
    sd = predict.state_dict(cfg, traffic, seed, device)
    calls = predict.make_pool(traffic, seed, device)
    images = [im for call in calls[:int(traffic["check_calls"])] for im in call]
    arms, detail = {}, []
    with R.f32_exact():
        ref = compare.reference_outputs(images, sd, m, device)
        low = compare.reference_outputs(images, sd, m, device, R.fp8_quant)
        for arm, outputs, fault in [("fp8", low, None), ("keep_all", ref, "keep_all"),
                                    ("one_per_class", ref, "one_per_class"), ("empty", ref, "empty"),
                                    ("lowest_k", ref, "lowest_k")]:
            detail.append(f"arm {arm}:")
            arms[arm] = compare.predict_checks(images, compare.detections_of(outputs, m, fault), sd, m,
                                               device, detail, outputs=ref)
    print("\n".join(detail), file=sys.stderr)
    return arms


def train_arms(cfg, traffic, seed, device):
    from rnbench import train, weights
    from rnbench import reference as R

    m = cfg["model"]
    world = int(traffic.get("world", 1))
    sd = weights.make_state_dict(m["backbone_kind"], m["num_classes"], m["prior"], seed, device)
    bucket = (R.ceil32(m["min_size"]), R.ceil32(m["max_size"]))
    ranks = [train.make_batches(traffic, seed, r, bucket, m["num_classes"], device, False)
             for r in range(world)]
    steps = [[ranks[r][k] for r in range(world)] for k in range(train.CHECK_STEPS)]

    def steps_of(**kw):
        chosen = kw.pop("steps", steps)
        return train.reference_steps(sd, chosen, m, cfg["optimizer"], device, **kw)

    def as_program(run, arm):
        params3 = {k: sd[k] + v for k, v in run["delta"].items()}
        detail = [f"arm {arm}:"]
        out = train.train_checks(run["losses"], run["d_p"], params3, sd, ref, detail)
        print("\n".join(detail), file=sys.stderr)
        return out

    with R.f32_exact():
        ref = steps_of()
        runs = {"fp8": steps_of(q=R.fp8_train_quant), "half": steps_of(half=True)}
        if world > 1:
            runs["no_exchange"] = steps_of(steps=[s[:1] for s in steps])
        arms = {arm: as_program(run, arm) for arm, run in runs.items()}
    # A step that returns its state unchanged: every leaf's change reads 1.
    arms["unchanged"] = {"change_gap": 1.0}
    return arms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(HERE.parent))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    import torch

    from rnbench.spec import Spec

    spec = Spec(Path(args.root))
    cell = spec.cell(args.workload)
    cfg, traffic = spec.config(cell), spec.traffic(cell)
    device = torch.device(args.device)
    arms_of = {"predict": predict_arms, "train": train_arms}[traffic["driver"]]
    for seed in args.seeds:
        arms = arms_of(cfg, traffic, seed, device)
        print(json.dumps({"workload": cell["name"], "seed": seed, "arms": arms}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
