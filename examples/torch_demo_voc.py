"""Demo-notebook flow on the PyTorch port: VOC XML -> CSV -> train -> test -> save -> reload -> predict.

Counterpart of ``examples/demo_voc.py`` (the reference ``demo.ipynb``):

1. scrape VOC XML annotations into the reference CSV schema
2. draw the ground truth of the first image (``gt.png``)
3. train with hparams-style config (resnet34, SGD + CosineAnnealingLR)
4. COCO-API test evaluation
5. save the detector's reference-schema ``state_dict``, reload it into a
   bare ``Retinanet``, run ``predict``
6. draw the predictions (``pred.png``)

    python examples/torch_demo_voc.py --ann-dir Annotations/ --img-dir JPEGImages/ \\
        --epochs 20 --out-dir /tmp/demo
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from pytorch_retinanet_tpu_torch import OmegaConf, RetinaNetModel, Trainer
from pytorch_retinanet_tpu_torch.data import convert_annotations_to_df, generate_pascal_category_names
from pytorch_retinanet_tpu_torch.models import Retinanet
from pytorch_retinanet_tpu_torch.utils import (
    seed_everything,
    visualize_boxes_and_labels_on_image_array,
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ann-dir", required=True)
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--backbone", default="resnet34")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--min-size", type=int, default=800)
    ap.add_argument("--max-size", type=int, default=1333)
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu")
    ap.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"],
                    help="float32 where the CPU build's bf16 convolutions go non-finite")
    args = ap.parse_args()

    seed_everything(123)  # demo.ipynb uses pl.seed_everything(123)
    os.makedirs(args.out_dir, exist_ok=True)

    # 1. VOC XML -> CSV (reference demo: convert_annotations_to_df + get_pascal)
    df = convert_annotations_to_df(args.ann_dir, args.img_dir)
    label_map = generate_pascal_category_names(df)
    num_classes = len(label_map) - 1
    csv_path = os.path.join(args.out_dir, "pascal_train.csv")
    df.to_csv(csv_path, index=False)
    print(f"{len(df)} boxes / {df['filename'].nunique()} images, classes: {label_map[1:]}")

    # 2. GT visualization on the first image
    import cv2

    sample = df.iloc[0]["filename"]
    img = cv2.cvtColor(cv2.imread(sample), cv2.COLOR_BGR2RGB)
    gt = df[df["filename"] == sample]
    viz = visualize_boxes_and_labels_on_image_array(
        img,
        gt[["xmin", "ymin", "xmax", "ymax"]].to_numpy(),
        gt["labels"].to_numpy(),
        None,
        label_map,
    )
    cv2.imwrite(os.path.join(args.out_dir, "gt.png"), cv2.cvtColor(viz, cv2.COLOR_RGB2BGR))

    # 3. train (demo hparams: resnet34, SGD, CosineAnnealingLR, seed 123)
    model_args = {
        "backbone_kind": args.backbone,
        "num_classes": num_classes,
        "min_size": args.min_size,
        "max_size": args.max_size,
        "pretrained": False,
        "compute_dtype": args.compute_dtype,
    }
    conf = OmegaConf.create(
        {
            "model": model_args,
            "dataset": {
                "kind": "csv",
                "trn_paths": csv_path,
                "valid_paths": False,
                "test_paths": csv_path,
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
                "params": {"lr": 0.001, "momentum": 0.9, "weight_decay": 1e-4},
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
    model = RetinaNetModel(conf, device=args.device)
    trainer = Trainer(
        max_epochs=args.epochs, checkpoint_dir=os.path.join(args.out_dir, "ckpt")
    )
    trainer.fit(model)
    results = trainer.test(model)
    print("test:", results)

    # 5. save -> reload into a bare Retinanet (demo: torch.save(state_dict) +
    #    Retinanet(**model_args).load_state_dict)
    state_path = os.path.join(args.out_dir, "retinanet_state.pt")
    model.net.save_torch_state_dict(state_path)
    net = Retinanet(**model_args, device=args.device)
    net.load_torch_state_dict(state_path)

    # 6. predict + visualize
    preds = net.predict([img])[0]
    viz = visualize_boxes_and_labels_on_image_array(
        img, preds["boxes"], preds["labels"], preds["scores"], label_map,
        min_score_thresh=0.3,
    )
    cv2.imwrite(
        os.path.join(args.out_dir, "pred.png"), cv2.cvtColor(viz, cv2.COLOR_RGB2BGR)
    )
    print(f"wrote {args.out_dir}/gt.png and pred.png; "
          f"{int((preds['scores'] > 0.3).sum())} detections above 0.3")


if __name__ == "__main__":
    main()
