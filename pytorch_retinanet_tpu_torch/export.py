"""Serving export: the inference program as a ``torch.export`` artifact.

Counterpart of ``pytorch_retinanet_tpu/export.py``. The inference step,
``Retinanet._predict_impl`` (fused stem with the normalize inside -> trunk
-> FPN -> head -> postprocess with the NMS kernel), is recorded by
``torch.export`` into one ``.pt2`` artifact per (batch, resolution
bucket), with the weights and the bucket's anchors baked in.
Shapes are static, as the buckets are. The artifact runs on the device it
was exported on: export on the card to serve on the card.

One difference from the JAX artifact, which any JAX process can load: the
graph holds the port's two custom ops, ``retinanet_torch::stem_forward``
and ``retinanet_torch::nms_keep_mask`` (``kernels/stem.py``,
``kernels/nms.py``), so the loading process must import
``pytorch_retinanet_tpu_torch`` (this module does), which registers them.

Usage::

    from pytorch_retinanet_tpu_torch.export import export_inference, load_exported

    blob = export_inference(net, batch_size=8, wire_dtype="uint8")  # bytes
    infer = load_exported(blob)                  # or a path to a .pt2
    dets = infer(images, image_sizes)            # dict of numpy arrays

CLI: ``python tools/torch_export_model.py --backbone resnet50 --batch 8``.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from .models.retinanet import resolution_buckets

Tensor = torch.Tensor

WIRE_DTYPES = {"float32": torch.float32, "uint8": torch.uint8}
OUTPUTS = ("boxes", "scores", "labels", "valid")
# The artifact's own copy of the sidecar's facts, read before the program loads.
_META_FILE = "retinanet_meta.json"


class InferenceProgram(nn.Module):
    """``Retinanet._predict_impl`` on one bucket: ``forward(images,
    image_sizes) -> (boxes, scores, labels, valid)``. The detector module
    and the bucket's anchors are registered here, so that the export lifts
    them into the artifact."""

    def __init__(self, net, bucket: Tuple[int, int]):
        super().__init__()
        self.net = net
        self.module = net.module
        anchors = net._anchors_for(tuple(bucket))
        for i, a in enumerate(anchors):
            self.register_buffer(f"anchors_{i}", a)
        self.num_levels = len(anchors)

    def forward(self, images: Tensor, image_sizes: Tensor):
        anchors = [getattr(self, f"anchors_{i}") for i in range(self.num_levels)]
        return tuple(self.net._predict_impl(images, image_sizes, anchors))


def _meta(net, batch_size: int, wire_dtype: str) -> dict:
    return {
        "min_size": int(net.min_size),
        "max_size": int(net.max_size),
        "batch_size": int(batch_size),
        "num_classes": int(net.num_classes),
        "backbone": net.backbone_kind,
        "score_thres": float(net.score_thres),
        "nms_thres": float(net.nms_thres),
        "wire_dtype": wire_dtype,
        "device": net.device.type,
    }


def export_inference(
    net,
    batch_size: int,
    bucket: Optional[Tuple[int, int]] = None,
    wire_dtype: str = "float32",
) -> bytes:
    """Serialize the inference step for one (batch, bucket) configuration.

    Args:
      net: a :class:`..models.Retinanet`; its weights are baked in, and the
        artifact runs on ``net.device``.
      batch_size: static batch size of the program.
      bucket: (H, W) padded input shape; defaults to the landscape bucket
        (``resolution_buckets(min_size, max_size)[0]``).
      wire_dtype: the image input's dtype, "float32" (values in [0, 1]) or
        "uint8" (raw bytes, normalized by the fused stem), a quarter of the
        bytes a request uploads.

    Returns:
      The ``torch.export.save`` bytes of the program. Its inputs: ``images
      [B, H, W, 3]`` in the wire dtype and ``image_sizes [B, 2] f32`` (each
      resized image's (h, w), for box clipping); its outputs ``(boxes [B, D,
      4], scores [B, D], labels [B, D], valid [B, D])``.
    """
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"wire_dtype must be float32 or uint8, got {wire_dtype!r}")
    if bucket is None:
        bucket = resolution_buckets(net.min_size, net.max_size)[0]
    h, w = int(bucket[0]), int(bucket[1])
    args = (
        torch.zeros((batch_size, h, w, 3), dtype=WIRE_DTYPES[wire_dtype], device=net.device),
        torch.ones((batch_size, 2), dtype=torch.float32, device=net.device),
    )
    program = InferenceProgram(net, (h, w))
    with torch.no_grad(), net._mode(False):
        exported = torch.export.export(program, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(exported, buf,
                      extra_files={_META_FILE: json.dumps(_meta(net, batch_size, wire_dtype))})
    return buf.getvalue()


def save_exported(
    net,
    path: str,
    batch_size: int,
    bucket: Optional[Tuple[int, int]] = None,
    wire_dtype: str = "float32",
) -> str:
    """:func:`export_inference` to a file; returns the path.

    Also writes the ``<path>.json`` sidecar of the JAX package: the true
    resize rule (min / max size: the padded bucket is ceil32'd and cannot
    give it back) and the model's facts, plus the device it runs on.
    """
    blob = export_inference(net, batch_size, bucket, wire_dtype)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(blob)
    with open(path + ".json", "w") as f:
        json.dump(_meta(net, batch_size, wire_dtype), f, indent=1)
    return path


class InShape(NamedTuple):
    """One input of the program, as JAX's ``in_avals`` gives it."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def artifact_meta(blob: bytes) -> Dict:
    """The facts ``export_inference`` stored in the artifact, read without
    loading its program."""
    with zipfile.ZipFile(io.BytesIO(blob)) as archive:
        for name in archive.namelist():
            if name.endswith(_META_FILE):
                return json.loads(archive.read(name))
    raise ValueError("not an artifact of export_inference: it holds no " + _META_FILE)


def load_exported(blob_or_path: Union[bytes, str, os.PathLike]):
    """Load an exported inference program.

    Returns ``infer(images, image_sizes) -> {"boxes", "scores", "labels",
    "valid"}`` as numpy, with

    * ``infer.dispatch(images, image_sizes)``: enqueue the program and
      return its device tensors ``(boxes, scores, labels, valid)`` without
      waiting for them (for request pipelining, ``examples/torch_serve.py``);
      inputs may be numpy arrays or tensors, pinned ones upload without
      blocking;
    * ``infer.in_shapes``: the inputs' (shape, dtype), from the program;
    * ``infer.meta``: the artifact's facts (the sidecar's keys);
    * ``infer.device`` and ``infer.program`` (the loaded module).

    Raises where the artifact's device is absent (a CUDA artifact without a
    card).
    """
    if isinstance(blob_or_path, (str, os.PathLike)):
        with open(blob_or_path, "rb") as f:
            blob = f.read()
    else:
        blob = bytes(blob_or_path)
    meta = artifact_meta(blob)
    if meta["device"] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("this artifact was exported for CUDA, and CUDA is not available")
    exported = torch.export.load(io.BytesIO(blob))
    program = exported.module()
    device = torch.device(meta["device"])
    nodes = {n.name: n for n in exported.graph.nodes if n.op == "placeholder"}
    in_shapes = tuple(
        InShape(tuple(nodes[name].meta["val"].shape), nodes[name].meta["val"].dtype)
        for name in exported.graph_signature.user_inputs
    )
    wire = in_shapes[0].dtype

    def dispatch(images, image_sizes):
        """Enqueue one batch; returns the device tensors without a sync."""
        x = torch.as_tensor(images)
        x = x.to(device, non_blocking=x.is_pinned()).to(wire)
        s = torch.as_tensor(image_sizes)
        s = s.to(device, non_blocking=s.is_pinned()).to(torch.float32)
        with torch.inference_mode():
            return tuple(program(x, s))

    def infer(images, image_sizes) -> Dict[str, np.ndarray]:
        return {k: v.cpu().numpy() for k, v in zip(OUTPUTS, dispatch(images, image_sizes))}

    infer.dispatch = dispatch
    infer.in_shapes = in_shapes
    infer.meta = meta
    infer.device = device
    infer.program = program
    return infer
