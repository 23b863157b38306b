"""Tensor ops of the port: resize, augmentation, metrics, label subsampling."""
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import (  # noqa: F401
    IMAGENET_MEAN, IMAGENET_STD, AugmentDraws, augment_batch, draw_augment,
    pad_reflect_hw)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import (  # noqa: F401
    confusion_matrix, iou_from_confusion, mean_iou_breakdown, pixel_accuracy)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.misc import downsample_labels  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import (  # noqa: F401
    interp_matrix, resize_bilinear)
