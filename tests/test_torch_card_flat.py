"""The flat postprocess and the parity tools on the card, at full width.

- the flat postprocess (``ops.process_detections_batch``, the top 4096 of the
  sigmoid over all 18.1M (anchor, class) pairs) on R50-FPN's head outputs
  (90 classes, prior 0.5, seed 0) for 8 seeded 800x1333 images, one image a
  call: through the NMS kernel equal to it through the plain version
  (labels, valid flags, boxes and scores), the kernel launched once a call
  and nothing else, no launch in the plain arm;
- ``tools/torch_parity_report.py`` at 800x1344, 90 classes, 8 images: every
  port row (flat and multilevel, plain and kernel NMS) at ΔAP +0.0000
  against the torch oracle, the NMS kernel once an image in each kernel row
  (and once more, in its untimed first call);
- ``tools/torch_loss_parity.py`` at 800x1344, batch 4, 90 classes: both
  arms within JAX's bar of the oracle, the match kernel 5 times in its arm
  and not in the plain one, the focal pair's forward 5 times in each.

Run on the card as ``tests/torch_card.py`` says.
"""

from __future__ import annotations

import pytest
import torch
from torch_card import (  # noqa: F401
    H, MAX_GT, W, check_detections, counted, dev, main_path_batch, main_path_net,
    valid_detections,
)

pytestmark = pytest.mark.cuda

FLAT_IMAGES = 8
FLAT_TOP_K = 4096  # the parity report's flat row: every planted candidate
PARITY_IMAGES = 8  # cut from the tool's 50 for time
LOSS_BATCH = 4  # the loss tool's configuration


@pytest.fixture(scope="module")
def heads(dev):
    """The first 8 images' head outputs, concatenated over the levels ([8,
    A, 90] logits and [8, A, 4] deltas in the head's bf16)."""
    from pytorch_retinanet_tpu_torch.models import apply_detector

    _, batch, _ = main_path_batch(dev)
    net = main_path_net()
    with torch.inference_mode():
        cls_levels, box_levels = apply_detector(net.module, batch[:FLAT_IMAGES],
                                                return_levels=True)
    yield torch.cat(cls_levels, 1), torch.cat(box_levels, 1)
    del net, batch
    torch.cuda.empty_cache()


def test_flat_postprocess_at_full_width_kernel_arm_equals_plain_arm(heads, dev):
    from pytorch_retinanet_tpu_torch.ops import generate_anchors, process_detections_batch

    cls, box = heads
    anchors = torch.from_numpy(generate_anchors((H, W))).to(dev)
    sizes = torch.tensor([[800.0, 1333.0]] * FLAT_IMAGES, device=dev)

    def arm(kernel):
        with torch.inference_mode():
            return [process_detections_batch(cls[i:i + 1], box[i:i + 1], anchors, sizes[i:i + 1],
                                             pre_nms_top_k=FLAT_TOP_K, use_kernel=kernel)
                    for i in range(FLAT_IMAGES)]

    got, launches = counted(lambda: arm(True))
    ref, plain_launches = counted(lambda: arm(False))
    assert launches == {k: FLAT_IMAGES if k == "nms_keep_mask" else 0 for k in launches}
    assert not any(plain_launches.values())
    for g, r in zip(got, ref):
        assert all(torch.equal(a, b) for a, b in zip(g, r))
    check_detections([valid_detections(d)[0] for d in got])


def test_parity_report_at_full_width(dev):
    import torch_parity_report as report

    res, launches = counted(lambda: report.run(PARITY_IMAGES, 90, (H, W), dev))
    # Each of the two kernel rows: an untimed first call, then one call an image.
    assert launches == {k: 2 * (PARITY_IMAGES + 1) if k == "nms_keep_mask" else 0
                        for k in launches}
    for r in res["rows"]:
        assert f"{r['delta_ap']:+.4f}" == "+0.0000", r
        assert r["nms_launches"] == (PARITY_IMAGES if r["pipeline"].endswith("NMS kernel") else 0)


def test_loss_parity_at_full_width(dev):
    import torch_loss_parity as loss

    res, launches = counted(lambda: loss.run(H, W, LOSS_BATCH, 90, MAX_GT, dev))
    assert launches == {k: {"match_targets": 5, "focal_loss": 2 * 5}.get(k, 0) for k in launches}
    assert res["within_bar"], (res["max_abs_delta"], res["bar"])
    assert res["port_kernel"]["match_launches"] == 5 and res["port_plain"]["match_launches"] == 0
