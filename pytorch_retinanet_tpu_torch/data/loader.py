"""Host-side detection loader producing fixed-shape batches of CPU tensors.

Counterpart of ``pytorch_retinanet_tpu/data/loader.py``: the same grouping,
shuffling, per-sample generators, sharding and collation, so that both
loaders give the same batches, bit for bit, from the same files. A batch is
a dict of CPU tensors:

    images      [B, H, W, 3] float32 in [0, 1], or uint8 (the wire format
                the detector normalizes from)
    image_sizes [B, 2] float32 (resized h, w before padding)
    orig_sizes  [B, 2] float32 (h, w before the resize)
    image_ids   [B] int64 (-1 on padding rows)
    boxes       [B, MAX_GT, 4] float32 XYXY in resized coordinates
    labels      [B, MAX_GT] int32
    valid       [B, MAX_GT] bool
    batch_mask  [B] bool (False on the padding rows of a partial final batch
                and on a whole cross-shard filler batch)

With ``pin_memory=True`` (what ``RetinaNetModel`` asks for when its
detector is on CUDA) the tensors are in page-locked memory, so the Trainer
uploads them with ``non_blocking=True``.

Decode, augmentation and the resize run on the host in a thread pool with a
bounded prefetch queue; a worker's exception re-raises in the consumer. The
resize is ``cv2.resize(INTER_LINEAR)``, as the JAX loader's.
"""

from __future__ import annotations

import math
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import config as C


def pad_targets(
    boxes: np.ndarray, labels: np.ndarray, max_gt: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad [n, 4] / [n] GT to [max_gt] rows with a validity mask; boxes past
    ``max_gt`` are dropped."""
    n = min(len(boxes), max_gt)
    out_boxes = np.zeros((max_gt, 4), np.float32)
    out_labels = np.zeros((max_gt,), np.int32)
    out_valid = np.zeros((max_gt,), bool)
    out_boxes[:n] = boxes[:n]
    out_labels[:n] = labels[:n]
    out_valid[:n] = True
    return out_boxes, out_labels, out_valid


def _ceil32(v: int) -> int:
    return int(math.ceil(v / 32.0) * 32)


def resize_for_bucket_host(
    image: np.ndarray, min_size: int, max_size: int, *, wire_dtype=np.float32
) -> Tuple[np.ndarray, Tuple[int, int], Tuple[int, int], Tuple[int, int]]:
    """The reference resize rule on the host with ``cv2.resize(INTER_LINEAR)``,
    without the bucket pad, as the JAX package's ``resize_for_bucket``.

    Returns (resized HWC array in `wire_dtype`, resized (h, w), original
    (h, w), bucket (pad_h, pad_w)). A float image converts to the uint8 wire
    by scaling by 255, clipping and truncating; a uint8 one to the f32 wire
    by 1/255.
    """
    import cv2

    orig_h, orig_w = image.shape[:2]
    scale = min(min_size / min(orig_h, orig_w), max_size / max(orig_h, orig_w))
    new_h, new_w = int(round(orig_h * scale)), int(round(orig_w * scale))
    resized = cv2.resize(np.asarray(image), (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    wire_dtype = np.dtype(wire_dtype)
    if wire_dtype == np.uint8:
        if resized.dtype != np.uint8:
            resized = np.clip(np.asarray(resized, np.float32) * 255.0, 0, 255).astype(np.uint8)
    elif resized.dtype == np.uint8:
        resized = resized.astype(np.float32) / 255.0
    else:
        resized = resized.astype(np.float32)
    if orig_h >= orig_w:  # portrait (or square) bucket
        pad_h, pad_w = _ceil32(max_size), _ceil32(min_size)
    else:
        pad_h, pad_w = _ceil32(min_size), _ceil32(max_size)
    return resized, (new_h, new_w), (orig_h, orig_w), (max(pad_h, new_h), max(pad_w, new_w))


class DetectionLoader:
    """Iterable over fixed-shape batches from an (image, target, id) dataset.

    ``batch_size`` is per shard. Batches are grouped by orientation bucket
    (from ``get_height_and_width`` metadata, without decoding an image), so
    a batch pads to one of the two buckets; a dataset without metadata
    letterboxes each batch to its largest image's bucket. ``shuffle``
    permutes the indices and the batch order with ``seed + epoch``; each
    sample's augmentation draws from its own generator keyed on ``(seed,
    epoch, index)``, whatever thread loads it. ``drop_last`` drops each
    group's partial batch; otherwise ``pad_last`` pads it to ``batch_size``
    with masked rows. With ``num_shards > 1`` every shard yields as many
    batches as the largest, repeating real batches as fillers whose
    ``batch_mask`` is all False. ``image_dtype`` is the wire: ``np.float32`` (the
    default), ``np.uint8``, or ``"auto"`` (uint8 when the transformed samples
    are uint8, else float32).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        *,
        min_size: int = C.MIN_IMAGE_SIZE,
        max_size: int = C.MAX_IMAGE_SIZE,
        max_gt: int = C.MAX_GT_BOXES,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_last: bool = True,
        num_workers: int = 4,
        prefetch: int = 2,
        seed: int = 0,
        shard: int = 0,
        num_shards: int = 1,
        image_dtype=np.float32,
        pin_memory: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.min_size = min_size
        self.max_size = max_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_last = pad_last
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed
        self.shard = shard
        self.num_shards = num_shards
        self.image_dtype = None if image_dtype == "auto" else np.dtype(image_dtype)
        self.pin_memory = pin_memory
        self.epoch = 0
        self._group_ids: Optional[np.ndarray] = None
        # "auto" resolves once, from the first sample any worker loads.
        self._wire_lock = threading.Lock()

    # ------------------------------------------------------------------ #
    # Orientation grouping and batch plan
    # ------------------------------------------------------------------ #
    def _groups(self) -> np.ndarray:
        """Orientation bucket per dataset index: 0 = portrait (h >= w), 1 =
        landscape, -1 = unknown (no metadata). Never decodes an image."""
        if self._group_ids is None:
            n = len(self.dataset)
            ids = np.full(n, -1, np.int8)
            get_hw = getattr(self.dataset, "get_height_and_width", None)
            if get_hw is not None:
                for i in range(n):
                    hw = get_hw(i)
                    if hw is not None:
                        h, w = hw
                        ids[i] = 0 if h >= w else 1
            self._group_ids = ids
        return self._group_ids

    def _shard_batch_count(self, shard: int) -> int:
        """Batches `shard` yields before the cross-shard equalization."""
        idxs = list(range(shard, len(self.dataset), self.num_shards))
        groups = self._groups()[idxs] if idxs else np.zeros(0, np.int8)
        total = 0
        for g in np.unique(groups):
            n = int((groups == g).sum())
            total += n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return total

    def __len__(self) -> int:
        if self.num_shards > 1:
            return max(self._shard_batch_count(s) for s in range(self.num_shards))
        return self._shard_batch_count(self.shard)

    def _batched_indices(self) -> List[Tuple[List[int], bool]]:
        """Shard, shuffle, group by orientation, batch within each group,
        shuffle the batch order: (indices, is_filler) pairs."""
        idxs = list(range(self.shard, len(self.dataset), self.num_shards))
        rng = np.random.default_rng(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(idxs)
        group_ids = self._groups()
        by_group: Dict[int, List[int]] = {}
        for i in idxs:
            by_group.setdefault(int(group_ids[i]), []).append(i)
        batches: List[Tuple[List[int], bool]] = []
        for g in sorted(by_group):
            members = by_group[g]
            batches.extend((members[i: i + self.batch_size], False)
                           for i in range(0, len(members), self.batch_size))
        if self.drop_last:
            batches = [b for b in batches if len(b[0]) == self.batch_size]
        if self.num_shards > 1:
            target = max(self._shard_batch_count(s) for s in range(self.num_shards))
            if not batches and target > 0 and len(self.dataset):
                batches = [([0], True)]  # an empty shard: all fillers
            k = 0
            while batches and len(batches) < target:
                batches.append((batches[k % len(batches)][0], True))
                k += 1
        if self.shuffle:
            rng.shuffle(batches)
        return batches

    # ------------------------------------------------------------------ #
    # Samples and batches
    # ------------------------------------------------------------------ #
    def _load_sample(self, idx: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        if hasattr(self.dataset, "get_sample"):
            rng = np.random.default_rng([self.seed, epoch, idx])
            image, target, image_id = self.dataset.get_sample(idx, rng)
        else:
            image, target, image_id = self.dataset[idx]
        with self._wire_lock:
            if self.image_dtype is None:  # "auto": bytes stay bytes, floats stay float32
                self.image_dtype = np.dtype(np.uint8 if image.dtype == np.uint8 else np.float32)
            wire = self.image_dtype
        orig_h, orig_w = image.shape[:2]
        resized, (new_h, new_w), _, bucket = resize_for_bucket_host(
            image, self.min_size, self.max_size, wire_dtype=wire)
        boxes = np.asarray(target["boxes"], np.float32).reshape(-1, 4)
        if len(boxes):
            scale_y, scale_x = new_h / orig_h, new_w / orig_w
            boxes = boxes * np.array([scale_x, scale_y, scale_x, scale_y], np.float32)
        labels = np.asarray(target["labels"], np.int64)
        pboxes, plabels, pvalid = pad_targets(boxes, labels, self.max_gt)
        return {
            "image": resized,
            "bucket": bucket,
            "image_size": np.asarray([new_h, new_w], np.float32),
            "orig_size": np.asarray([orig_h, orig_w], np.float32),
            "image_id": np.int64(image_id),
            "boxes": pboxes,
            "labels": plabels,
            "valid": pvalid,
        }

    def _tensor(self, array: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(array))
        return t.pin_memory() if self.pin_memory else t

    def _collate(self, samples: Sequence[Dict[str, np.ndarray]],
                 is_filler: bool = False) -> Dict[str, torch.Tensor]:
        """Write each resized image into the batch buffer (pinned when asked)
        at its top-left; pad a partial batch with masked rows."""
        n_real = len(samples)
        n_total = self.batch_size if (self.pad_last and n_real < self.batch_size) else n_real
        max_h = max(s["bucket"][0] for s in samples)
        max_w = max(s["bucket"][1] for s in samples)
        dtype = torch.from_numpy(samples[0]["image"][:0]).dtype
        images = torch.zeros((n_total, max_h, max_w, 3), dtype=dtype, pin_memory=self.pin_memory)
        view = images.numpy()
        for i, s in enumerate(samples):
            h, w = s["image"].shape[:2]
            view[i, :h, :w] = s["image"]

        def stack_padded(key):
            arr = np.stack([s[key] for s in samples])
            if n_total > n_real:
                pad = np.zeros((n_total - n_real, *arr.shape[1:]), arr.dtype)
                if key in ("image_size", "orig_size"):
                    pad[:] = arr[-1]  # nonzero, for the rescale's division
                arr = np.concatenate([arr, pad])
            return self._tensor(arr)

        batch_mask = np.zeros(n_total, bool)
        if not is_filler:
            batch_mask[:n_real] = True
        image_ids = np.concatenate([np.asarray([s["image_id"] for s in samples], np.int64),
                                    np.full(n_total - n_real, -1, np.int64)])
        return {
            "images": images,
            "image_sizes": stack_padded("image_size"),
            "orig_sizes": stack_padded("orig_size"),
            "image_ids": self._tensor(image_ids),
            "boxes": stack_padded("boxes"),
            "labels": stack_padded("labels"),
            "valid": stack_padded("valid"),
            "batch_mask": self._tensor(batch_mask),
        }

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        epoch = self.epoch
        batches = self._batched_indices()
        self.epoch += 1
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """A bounded put that re-checks `stop`, so that a consumer that
            leaves early cannot park the producer in ``q.put`` forever."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idxs, is_filler in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(lambda i: self._load_sample(i, epoch), batch_idxs))
                        if not put_or_stop(self._collate(samples, is_filler=is_filler)):
                            return
            except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
                put_or_stop(e)
                return
            put_or_stop(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
