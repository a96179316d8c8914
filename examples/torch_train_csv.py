"""End-to-end example of the PyTorch port: train and evaluate RetinaNet on a CSV dataset.

Counterpart of ``examples/train_csv.py`` (the reference demo's flow: CSV ->
fit -> test). Checkpoints land in ``--checkpoint-dir`` (``last/``,
``best/``), which ``examples/torch_infer.py --state`` reads.

    python examples/torch_train_csv.py --csv train.csv --val-csv val.csv \\
        --num-classes 4 --epochs 10

``--spatial N`` splits each image's height over N ranks (one process a
rank, frozen BN; the batch size is a data shard's), as the JAX example's
flag splits it over N chips. Start the ranks with torchrun, which names the
world to ``parallel.init_distributed``:

    torchrun --nproc_per_node 2 examples/torch_train_csv.py --spatial 2 ...
    torchrun --nproc_per_node 2 examples/torch_train_csv.py --spatial 2 \\
        --device cpu --compute-dtype float32 ...             # gloo ranks on the CPU
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer, parallel
from pytorch_retinanet_tpu_torch.utils import seed_everything


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csv", required=True, help="training CSV (reference schema)")
    ap.add_argument("--val-csv", default=None)
    ap.add_argument("--test-csv", default=None)
    ap.add_argument("--num-classes", type=int, required=True)
    ap.add_argument("--backbone", default="resnet50")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--min-size", type=int, default=800)
    ap.add_argument("--max-size", type=int, default=1333)
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument(
        "--spatial", type=int, default=1,
        help="split each image's height over N ranks while training (frozen BN only; "
        "start the ranks with torchrun); the data axis is the world size over N",
    )
    ap.add_argument(
        "--accumulate", type=int, default=1,
        help="gradient accumulation window (Lightning accumulate_grad_batches "
        "semantics: window-mean grads, clip at optimizer-step time, partial "
        "epoch-end windows flushed)",
    )
    ap.add_argument("--device", default="cuda", help="cuda, or cpu")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="float32 where the CPU build's bf16 convolutions go non-finite")
    args = ap.parse_args()

    seed_everything(args.seed)
    conf = OmegaConf.create(
        {
            "model": {
                "backbone_kind": args.backbone,
                "num_classes": args.num_classes,
                "min_size": args.min_size,
                "max_size": args.max_size,
                "pretrained": False,
                "compute_dtype": args.compute_dtype,
            },
            "dataset": {
                "kind": "csv",
                "trn_paths": args.csv,
                "valid_paths": args.val_csv or False,
                "test_paths": args.test_csv or args.val_csv or args.csv,
            },
            "dataloader": {
                "train_bs": args.batch_size,
                "valid_bs": args.batch_size,
                "test_bs": args.batch_size,
                "args": {"num_workers": 8},
            },
            "transforms": [
                {"class_name": "albumentations.HorizontalFlip", "params": {"p": 0.5}}
            ],
            "optimizer": {
                "class_name": "torch.optim.SGD",
                "params": {"lr": args.lr, "momentum": 0.9, "weight_decay": 1e-4},
            },
            "scheduler": {
                "class_name": "torch.optim.lr_scheduler.CosineAnnealingLR",
                "params": {"T_max": args.epochs},
                "interval": "epoch",
                "frequency": 1,
                "monitor": False,
            },
        }
    )

    kwargs = {}
    if args.spatial > 1:
        cpu = args.device == "cpu"
        parallel.init_distributed(backend="gloo" if cpu else None)
        kwargs["mesh"] = parallel.make_train_mesh(
            ["cpu"] * parallel.get_world_size() if cpu else None, spatial=args.spatial)
    model = RetinaNetModel(conf, device=args.device)
    trainer = Trainer(
        max_epochs=args.epochs,
        checkpoint_dir=args.checkpoint_dir,
        accumulate_grad_batches=args.accumulate,
        **kwargs,
    )
    metrics = trainer.fit(model)
    print("train metrics:", {k: round(v, 4) for k, v in metrics.items()})
    results = trainer.test(model)
    print("test results:", results)


if __name__ == "__main__":
    main()
