from detectron2_tpu_torch.data.transforms.augmentation import (
    AugInput,
    Augmentation,
    AugmentationList,
    apply_augmentations,
    apply_transform_gens,
)
from detectron2_tpu_torch.data.transforms.augmentation_impl import (
    FixedSizeCrop,
    RandomApply,
    RandomCrop,
    RandomFlip,
    ResizeScale,
    ResizeShortestEdge,
)
from detectron2_tpu_torch.data.transforms.transform import (
    CropTransform,
    HFlipTransform,
    NoOpTransform,
    PadTransform,
    ResizeTransform,
    Transform,
    TransformList,
    VFlipTransform,
    pil_bilinear_resize,
)

__all__ = [k for k in globals().keys() if not k.startswith("_")]
