"""Where the R50-FPN engine fit of ``tests/test_torch_card_train.py`` stays finite, and why.

Run from the root of a checkout on a machine with the card:
``python3 tools/torch_engine_divergence.py [--root DIR] [--plain-only]``.
``--root`` runs another checkout's package and kernels (a ``git archive``
of an earlier commit, say) with this checkout's fit; ``--plain-only`` runs
only the fits that such an earlier Trainer takes (frozen BN; no
checkpoints, loggers or profiler).

The fit is that test's engine fit: R50-FPN, 90 classes, ``HPARAMS``
(``configs/hparams.yaml``: SGD, lr 0.001, momentum 0.9, no gradient
clipping, ReduceLROnPlateau on val_loss), the detector's seed-0 random
weights, seeded uint8 batches of 16 at 800x1344 (``HPARAMS``,
``seeded_batch`` and the step recorder are ``tools/torch_main_path.py``'s),
2 epochs of 3 steps and a 1-batch validation loader. It runs with
``warmup_steps`` 0 and 500 (500 is capped at a fifth of the 6 planned
steps: one step at 0.001 of the LR), each once with a plain Trainer and
once wired as the test wires it (``checkpoint_dir``, EarlyStopping,
LearningRateMonitor, CSV and TensorBoard loggers, the profiler over steps
2-3), and once more with live batch norm (``freeze_bn=False``) and a plain
Trainer. Per fit it prints each train step's LR and loss (a validation
step as ``("eval", 16)``), and the step at which the Trainer raised on a
non-finite loss, if it did; the last line is all of it as one JSON object.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

import torch

from torch_main_path import HPARAMS, recording, seeded_batch, served_model_class

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, STEPS, BATCH, BUCKET = 2, 3, 16, (800, 1344)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose package and kernels to run")
    ap.add_argument("--plain-only", action="store_true",
                    help="only the frozen-BN fits without checkpoints, loggers or profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs the card", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from pytorch_retinanet_tpu_torch import ConfigDict, Trainer

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[divergence] checkout {root}; card {smi}", flush=True)
    batches = [seeded_batch(BATCH, *BUCKET, 90, seed=10 + i) for i in range(STEPS)]
    val = [seeded_batch(BATCH, *BUCKET, 90, seed=20)]
    work = tempfile.mkdtemp(prefix="divergence-")
    results = []
    try:
        arms = [(warmup, wired, True) for warmup in (0, 500) for wired in (False, True)]
        arms += [(warmup, False, False) for warmup in (0, 500)]
        for warmup, wired, freeze_bn in arms:
            if args.plain_only and (wired or not freeze_bn):
                continue
            kw = {}
            if wired:
                from pytorch_retinanet_tpu_torch.engine import (
                    CSVLogger, EarlyStopping, LearningRateMonitor, TensorBoardLogger,
                )
                from pytorch_retinanet_tpu_torch.utils import ProfilerHook

                run = os.path.join(work, f"w{warmup}")
                kw = dict(checkpoint_dir=os.path.join(run, "ckpt"),
                          callbacks=[EarlyStopping(patience=5), LearningRateMonitor(),
                                     TensorBoardLogger(os.path.join(run, "logs"))],
                          logger=CSVLogger(os.path.join(run, "logs")))
            model = served_model_class()(
                ConfigDict(HPARAMS).merge({"model": {"freeze_bn": freeze_bn}}))
            model.loader, model.val_loader = batches, val
            trainer = Trainer(max_epochs=EPOCHS, warmup_steps=warmup,
                              log_every_n_steps=1, **kw)
            if wired:
                trainer.profiler = ProfilerHook(os.path.join(run, "profile"), start_step=1,
                                                num_steps=2)
            steps = recording(trainer)
            raised = None
            try:
                trainer.fit(model)
            except FloatingPointError:
                raised = trainer.global_step
            results.append({"warmup_steps": warmup, "wired": wired, "freeze_bn": freeze_bn,
                            "steps": steps, "non_finite_at_step": raised})
            print(f"[divergence] warmup_steps={warmup} wired={wired} freeze_bn={freeze_bn}: "
                  f"(lr, loss) {steps}; raised at step {raised}", flush=True)
            del model, trainer
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"card": smi, "root": root, "fits": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
