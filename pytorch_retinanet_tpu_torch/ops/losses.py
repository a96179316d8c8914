"""RetinaNet training losses, batched over padded GT.

Counterpart of ``pytorch_retinanet_tpu/ops/losses.py``, with its documented
departures from the reference's ``retinanet/losses.py``:

* focal alpha as in the paper: ``alpha`` (0.25) on foreground, ``1 - alpha``
  on background;
* no ``+1`` added to the logits;
* the modulating factor ``(1 - p_t)^gamma`` takes part in the gradient.

Shared with the reference: labels in ``[1, num_classes]`` with 0 for
background (the one-hot target drops column 0), both losses divided by
``clamp(num_foreground, 1)`` per image and averaged over the batch, and
ignored anchors in neither loss.

The targets (matcher, matched-GT lookup, encode) are built under
``torch.no_grad()``: they are constants with respect to the parameters. On
CUDA they come from the hand-written match kernel (``kernels/match.py``) by
default; ``use_match_kernel=False`` takes the plain composition for the
match alone. The classification term is the focal pair of
``kernels/focal.py`` on every device: one autograd Function on the logits
in their dtype and the integer labels (the kernels on CUDA, their plain
version on the CPU). :func:`sigmoid_focal_loss` and :func:`smooth_l1_loss`
stay as the elementwise reference it is held to.
``match_mesh`` splits the match over the batch rows of a process group, as
JAX's ``shard_map`` splits the kernel over a device mesh.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import (
    BBOX_REG_WEIGHTS,
    FOCAL_LOSS_ALPHA,
    FOCAL_LOSS_GAMMA,
    IOU_THRESHOLDS_BACKGROUND,
    IOU_THRESHOLDS_FOREGROUND,
    SMOOTH_L1_LOSS_BETA,
)
from ..kernels import match as _match
from ..kernels.focal import focal_loss_sums
from ..parallel import MeshPlan

Tensor = torch.Tensor


def smooth_l1_loss(pred: Tensor, target: Tensor, beta: float = SMOOTH_L1_LOSS_BETA) -> Tensor:
    """Elementwise smooth-L1 (Huber) loss, unreduced."""
    n = torch.abs(pred - target)
    if beta < 1e-5:
        return n
    return torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)


def sigmoid_focal_loss(
    logits: Tensor,
    targets: Tensor,
    alpha: float = FOCAL_LOSS_ALPHA,
    gamma: float = FOCAL_LOSS_GAMMA,
) -> Tensor:
    """Elementwise sigmoid focal loss from logits, unreduced:
    ``-alpha_t * (1 - p_t)^gamma * log(p_t)`` through a stable BCE."""
    bce = torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
    p = torch.sigmoid(logits)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
    return alpha_t * torch.pow(1.0 - p_t, gamma) * bce


def _normalize(reg_sum: Tensor, cls_sum: Tensor, num_fg: Tensor, reduction: str) -> Dict[str, Tensor]:
    norm = torch.clamp(num_fg.float(), min=1.0)
    classification_loss = cls_sum / norm
    regression_loss = reg_sum / norm
    if reduction == "mean":
        classification_loss = classification_loss.mean()
        regression_loss = regression_loss.mean()
    return {"classification_loss": classification_loss, "regression_loss": regression_loss}


def retinanet_loss(
    cls_logits: Tensor,
    box_deltas: Tensor,
    anchors: Tensor,
    gt_boxes: Tensor,
    gt_labels: Tensor,
    gt_valid: Tensor,
    *,
    num_classes: int,
    fg_iou_thr: float = IOU_THRESHOLDS_FOREGROUND,
    bg_iou_thr: float = IOU_THRESHOLDS_BACKGROUND,
    alpha: float = FOCAL_LOSS_ALPHA,
    gamma: float = FOCAL_LOSS_GAMMA,
    beta: float = SMOOTH_L1_LOSS_BETA,
    reg_weights: Sequence[float] = tuple(BBOX_REG_WEIGHTS),
    reduction: str = "mean",
    use_match_kernel: Optional[bool] = None,
) -> Dict[str, Tensor]:
    """Full RetinaNet loss over a padded batch.

    Args:
      cls_logits: [B, A, C] raw class logits.
      box_deltas: [B, A, 4] raw regression activations.
      anchors: [A, 4] XYXY anchors shared by the batch.
      gt_boxes: [B, N, 4] XYXY GT, padded.
      gt_labels: [B, N] int labels in [1, num_classes].
      gt_valid: [B, N] bool mask of real GT rows.
      reduction: "mean" (batch-averaged scalars) or "none" (per-image [B]).
      use_match_kernel: for the match alone: ``None`` takes the match
        kernel when the logits lie on CUDA and the plain composition on the
        CPU; ``True`` on the CPU raises. The focal term takes its kernels
        wherever the logits lie on CUDA.

    Returns:
      {"classification_loss", "regression_loss"}.
    """
    reg_sum, cls_sum, num_fg = _loss_sums(
        cls_logits, box_deltas, anchors, gt_boxes, gt_labels, gt_valid,
        num_classes=num_classes, fg_iou_thr=fg_iou_thr, bg_iou_thr=bg_iou_thr,
        alpha=alpha, gamma=gamma, beta=beta, reg_weights=reg_weights,
        use_match_kernel=use_match_kernel,
    )
    return _normalize(reg_sum, cls_sum, num_fg, reduction)


def retinanet_loss_levels(
    cls_levels: Sequence[Tensor],
    box_levels: Sequence[Tensor],
    anchors_levels: Sequence[Tensor],
    gt_boxes: Tensor,
    gt_labels: Tensor,
    gt_valid: Tensor,
    *,
    num_classes: int,
    fg_iou_thr: float = IOU_THRESHOLDS_FOREGROUND,
    bg_iou_thr: float = IOU_THRESHOLDS_BACKGROUND,
    alpha: float = FOCAL_LOSS_ALPHA,
    gamma: float = FOCAL_LOSS_GAMMA,
    beta: float = SMOOTH_L1_LOSS_BETA,
    reg_weights: Sequence[float] = tuple(BBOX_REG_WEIGHTS),
    reduction: str = "mean",
    use_match_kernel: Optional[bool] = None,
    match_mesh=None,
) -> Dict[str, Tensor]:
    """:func:`retinanet_loss` on per-level head outputs, the same result.

    Matching is per anchor and the normalizer a per-image count, so the loss
    decomposes into per-level sums that are combined before normalizing;
    this skips the cross-level concat of the head outputs. The match kernel
    runs once per level.

    ``match_mesh`` (a :class:`..parallel.MeshPlan` or a process group) is
    for callers whose ranks all hold the same global batch: rank r matches
    rows ``[r*B/W, (r+1)*B/W)`` and the ranks all-gather the targets, which
    equal the unsplit match's. The DDP Trainer does not pass it: each of
    its ranks holds only its own rows.
    """
    if isinstance(match_mesh, MeshPlan):
        group = match_mesh.group
    elif match_mesh is None or isinstance(match_mesh, dist.ProcessGroup):
        group = match_mesh
    else:
        raise TypeError(f"match_mesh takes a MeshPlan or a process group, not {match_mesh!r}")
    # Converted once here rather than once per level inside the match.
    gt_boxes, gt_labels, gt_valid = gt_boxes.float(), gt_labels.to(torch.int32), gt_valid.bool()
    reg_sum = cls_sum = num_fg = 0
    for cls_l, box_l, anc_l in zip(cls_levels, box_levels, anchors_levels):
        r, c, f = _loss_sums(
            cls_l, box_l, anc_l, gt_boxes, gt_labels, gt_valid,
            num_classes=num_classes, fg_iou_thr=fg_iou_thr, bg_iou_thr=bg_iou_thr,
            alpha=alpha, gamma=gamma, beta=beta, reg_weights=reg_weights,
            use_match_kernel=use_match_kernel, match_group=group,
        )
        reg_sum, cls_sum, num_fg = reg_sum + r, cls_sum + c, num_fg + f
    return _normalize(reg_sum, cls_sum, num_fg, reduction)


def _loss_sums(
    cls_logits: Tensor,
    box_deltas: Tensor,
    anchors: Tensor,
    gt_boxes: Tensor,
    gt_labels: Tensor,
    gt_valid: Tensor,
    *,
    num_classes: int,
    fg_iou_thr: float,
    bg_iou_thr: float,
    alpha: float,
    gamma: float,
    beta: float,
    reg_weights: Sequence[float],
    use_match_kernel: Optional[bool] = None,
    match_group=None,
):
    """Unnormalized per-image sums over one anchor set: (reg_sum [B],
    cls_sum [B], num_fg [B]), so that levels can be combined."""
    if cls_logits.shape[-1] != num_classes:
        raise ValueError(f"cls_logits has {cls_logits.shape[-1]} classes, num_classes is "
                         f"{num_classes}")
    on_cuda = cls_logits.device.type == "cuda"
    if use_match_kernel is None:
        use_match_kernel = on_cuda
    if use_match_kernel and not on_cuda:
        raise ValueError("use_match_kernel=True needs CUDA tensors: the match kernel has no CPU mode")
    box_deltas = box_deltas.float()
    with torch.no_grad():
        fn = _match.match_targets if use_match_kernel else _match.match_targets_plain
        if match_group is not None and dist.get_world_size(match_group) > 1:
            fn = _split_over_ranks(fn, match_group)
        matches, fg_labels, reg_targets = fn(
            torch.as_tensor(anchors, device=cls_logits.device).float(), gt_boxes.float(),
            gt_labels, gt_valid, fg_iou_thr, bg_iou_thr, tuple(reg_weights),
        )
        fg_mask = matches >= 0  # [B, A]
        num_fg = fg_mask.sum(dim=1)  # [B]

    reg_elem = smooth_l1_loss(box_deltas, reg_targets, beta)  # [B, A, 4]
    reg_sum = (reg_elem.sum(dim=-1) * fg_mask.float()).sum(dim=1)
    cls_sum = focal_loss_sums(cls_logits, fg_labels, matches, alpha, gamma)
    return reg_sum, cls_sum, num_fg


def _split_over_ranks(fn, group):
    """`fn(anchors, gt_boxes, gt_labels, gt_valid, *args)` run by each rank
    of `group` on its share of the batch rows, the outputs all-gathered in
    rank order along the batch."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)

    def split(anchors, gt_boxes, gt_labels, gt_valid, *args):
        b = gt_boxes.shape[0]
        if b % world:
            raise ValueError(f"match_mesh: batch {b} does not divide over {world} ranks")
        rows = slice(rank * b // world, (rank + 1) * b // world)
        outs = fn(anchors, gt_boxes[rows], gt_labels[rows], gt_valid[rows], *args)
        gathered = []
        for t in outs:
            parts = [torch.empty_like(t) for _ in range(world)]
            dist.all_gather(parts, t.contiguous(), group=group)
            gathered.append(torch.cat(parts))
        return tuple(gathered)

    return split
