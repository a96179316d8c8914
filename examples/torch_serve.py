"""Serving loop over an exported inference artifact of the PyTorch port.

Counterpart of ``examples/serve.py``: the artifact (``tools/torch_export_model.py``)
is the inference program with the weights baked in; this script is what a
server adds around it: host preprocessing into the artifact's bucket,
batched invocation, and the rescale of the boxes to each original image. It
builds no model and reads no weights.

* **uint8 wire**: an artifact exported with ``--wire-dtype uint8`` takes
  raw bytes and normalizes inside the fused stem: a quarter of the
  host-to-device bytes of float32.
* **Request pipelining**: batch i+1 is decoded, resized and dispatched
  before batch i's detections are read, so the host's work on the next
  batch runs while the card computes this one.
* **Pinned buffers**: on the card, a batch is assembled in one of a ring of two
  page-locked host buffers and uploaded without blocking; a buffer is
  refilled only after the event recorded behind its upload has completed.
  The detections come back, without blocking, into page-locked buffers,
  each batch's with its own event.

    python tools/torch_export_model.py --backbone resnet18 --num-classes 4 \\
        --min-size 64 --max-size 96 --batch 2 --wire-dtype uint8 --out-dir exported/
    python examples/torch_serve.py exported/resnet18_64x96_b2_u8.pt2 img1.jpg img2.jpg

The artifact needs ``pytorch_retinanet_tpu_torch`` importable: its graph
holds the port's custom ops (the fused stem and NMS kernels).
"""

from __future__ import annotations

import os
import sys
from collections import deque
from typing import Dict, List, Sequence

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch


def read_rgb(item):
    """An RGB uint8 array from a path (decoded with cv2), or `item` itself
    if it is already an array."""
    if isinstance(item, np.ndarray):
        return item
    import cv2

    raw = cv2.imread(str(item), cv2.IMREAD_COLOR)
    if raw is None:
        raise FileNotFoundError(f"could not read image: {item}")
    return cv2.cvtColor(raw, cv2.COLOR_BGR2RGB)


class _Slot:
    """One batch's host buffers: the inputs (page-locked on the card, with
    the event behind their upload) and the detections (page-locked, with
    the event behind their download)."""

    def __init__(self, infer, pinned: bool):
        (b, h, w, _), wire = infer.in_shapes[0].shape, infer.in_shapes[0].dtype
        self.images = torch.zeros((b, h, w, 3), dtype=wire, pin_memory=pinned)
        self.sizes = torch.ones((b, 2), dtype=torch.float32, pin_memory=pinned)
        self.uploaded = torch.cuda.Event() if pinned else None
        self.outputs = None
        self.downloaded = torch.cuda.Event() if pinned else None

    def wait_free(self) -> None:
        """Block until this slot's last upload has left the buffer."""
        if self.uploaded is not None:
            self.uploaded.synchronize()


def serve(infer, items: Sequence, *, depth: int = 2) -> List[Dict[str, np.ndarray]]:
    """Detections for every item, batched into the artifact's batch size.

    Args:
      infer: a loaded artifact (``export.load_exported``).
      items: image paths or RGB uint8 arrays.
      depth: batches in flight. 2, as served, dispatches batch i+1 before
        reading batch i's detections. 1 reads each batch before preparing
        the next: it exists only to time the loop without pipelining.

    Returns, per item, ``{"boxes" [n, 4], "scores" [n], "labels" [n]}`` in
    the item's original coordinates, as ``Retinanet.predict`` returns them.
    Raises ValueError for an image whose orientation maps to the other
    bucket.
    """
    from pytorch_retinanet_tpu_torch.data.loader import resize_for_bucket_host
    from pytorch_retinanet_tpu_torch.ops import rescale_boxes

    if depth not in (1, 2):
        raise ValueError(f"depth must be 1 or 2, got {depth}")
    (batch, bh, bw, _), wire = infer.in_shapes[0].shape, infer.in_shapes[0].dtype
    np_wire = np.uint8 if wire == torch.uint8 else np.float32
    min_size, max_size = infer.meta["min_size"], infer.meta["max_size"]
    on_card = infer.device.type == "cuda"
    slots = [_Slot(infer, on_card) for _ in range(2)]
    results: List[Dict[str, np.ndarray]] = [None] * len(items)  # type: ignore[list-item]
    pending: deque = deque()

    def emit(slot: _Slot, start: int, plans) -> None:
        if slot.downloaded is not None:
            slot.downloaded.synchronize()
        boxes, scores, labels, valid = slot.outputs
        for row, (new_hw, orig_hw) in enumerate(plans):
            n = int(valid[row].sum())
            # Copies: the slot's buffers take a later batch's detections.
            results[start + row] = {
                "boxes": rescale_boxes(boxes[row, :n], torch.tensor(new_hw, dtype=torch.float32),
                                       torch.tensor(orig_hw, dtype=torch.float32)).numpy(),
                "scores": scores[row, :n].numpy().copy(),
                "labels": labels[row, :n].numpy().copy(),
            }

    for i, start in enumerate(range(0, len(items), batch)):
        slot = slots[i % 2]
        slot.wait_free()
        images, sizes = slot.images.numpy(), slot.sizes.numpy()
        plans = []
        for row, item in enumerate(items[start:start + batch]):
            resized, (nh, nw), orig_hw, pad = resize_for_bucket_host(
                read_rgb(item), min_size, max_size, wire_dtype=np_wire)
            if pad != (bh, bw):
                name = item if isinstance(item, (str, os.PathLike)) else f"image {start + row}"
                raise ValueError(f"{name}: orientation maps to bucket {pad}, artifact is "
                                 f"{(bh, bw)}: export and serve the other bucket too")
            images[row, :nh, :nw] = resized
            images[row, :nh, nw:] = 0
            images[row, nh:] = 0
            sizes[row] = (nh, nw)
            plans.append(((nh, nw), orig_hw))
        images[len(plans):] = 0
        sizes[len(plans):] = 1
        # Dispatch this batch before reading the previous one.
        x = slot.images.to(infer.device, non_blocking=True)
        s = slot.sizes.to(infer.device, non_blocking=True)
        if on_card:
            slot.uploaded.record()
        out = infer.dispatch(x, s)
        if slot.outputs is None:
            slot.outputs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card) for t in out]
        for host, dev in zip(slot.outputs, out):
            host.copy_(dev, non_blocking=on_card)
        if on_card:
            slot.downloaded.record()
        pending.append((slot, start, plans))
        while len(pending) >= depth:
            emit(*pending.popleft())
    while pending:
        emit(*pending.popleft())
    return results


def main() -> None:
    if len(sys.argv) < 3:
        print(__doc__)
        raise SystemExit(1)
    artifact, *paths = sys.argv[1:]

    from pytorch_retinanet_tpu_torch.export import load_exported

    infer = load_exported(artifact)
    try:
        dets = serve(infer, paths)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    for p, det in zip(paths, dets):
        print(f"{p}: {len(det['scores'])} detections")
        for b, s, l in zip(det["boxes"], det["scores"], det["labels"]):
            print(f"  label={int(l)} score={float(s):.3f} box={b.round(1).tolist()}")


if __name__ == "__main__":
    main()
