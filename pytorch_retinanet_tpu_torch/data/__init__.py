"""Host-side data layer: datasets (coco/pascal/csv), transforms, loader, masks.

Counterpart of ``pytorch_retinanet_tpu/data``, with the same exports.
"""

from . import masks
from .coco import (
    COCOIndex,
    CocoDetectionDataset,
    convert_to_coco_api,
    get_coco,
    get_coco_api_from_dataset,
)
from .loader import DetectionLoader, pad_targets
from .pascal import (
    PascalDataset,
    convert_annotations_to_df,
    generate_pascal_category_names,
    get_pascal,
)
from .transforms import (
    TRANSFORM_REGISTRY,
    Blur,
    Compose,
    GaussNoise,
    HorizontalFlip,
    HueSaturationValue,
    RandomBrightnessContrast,
    RandomCrop,
    Resize,
    ShiftScaleRotate,
    ToFloat,
    Transform,
    VerticalFlip,
    build_transforms,
)

__all__ = [
    "Blur",
    "COCOIndex",
    "CocoDetectionDataset",
    "Compose",
    "GaussNoise",
    "HueSaturationValue",
    "RandomCrop",
    "Resize",
    "DetectionLoader",
    "HorizontalFlip",
    "PascalDataset",
    "RandomBrightnessContrast",
    "ShiftScaleRotate",
    "ToFloat",
    "TRANSFORM_REGISTRY",
    "Transform",
    "VerticalFlip",
    "build_transforms",
    "convert_annotations_to_df",
    "convert_to_coco_api",
    "generate_pascal_category_names",
    "get_coco",
    "get_coco_api_from_dataset",
    "get_pascal",
    "masks",
    "pad_targets",
]
