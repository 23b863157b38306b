"""Tensor ops of the port: resize, augmentation, metrics, label subsampling,
host label remapping."""
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import (  # noqa: F401
    IMAGENET_MEAN, IMAGENET_STD, AugmentDraws, augment_batch, draw_augment,
    pad_reflect_hw)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import (  # noqa: F401
    confusion_matrix, iou_from_confusion, mean_iou, mean_iou_breakdown,
    normalise_confusion_matrix, pixel_accuracy, single_class_iou, sliding_miou)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.misc import (  # noqa: F401
    clipped_argmax, downsample_labels)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.remap import (  # noqa: F401
    mask_from_network, mask_to_colormap, remap_mask_np)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import (  # noqa: F401
    interp_matrix, resize_bilinear)
