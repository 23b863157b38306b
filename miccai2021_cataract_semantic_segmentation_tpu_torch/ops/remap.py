"""Label-space remapping on the host, as LUT gathers (numpy).

Port of `remap_mask_np`, `mask_from_network` and `mask_to_colormap` from
the JAX package's ops/remap.py (the reference's utils/utils.py:23-47,
114-142). The canonical -> task remap runs on the host as frames are
decoded, so the card only ever sees dense network ids.
"""
from __future__ import annotations

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy


def remap_mask_np(mask: np.ndarray, task: int, to_network: bool = True) -> np.ndarray:
    """Canonical-id mask -> task-id mask. `to_network=True` folds the 255
    ignore value to index num_classes, a dense 0..num_label_values-1 id
    space."""
    lut = taxonomy.REMAP_LUTS_NETWORK[task] if to_network else taxonomy.REMAP_LUTS[task]
    return lut[mask]


def mask_from_network(mask: np.ndarray, task: int) -> np.ndarray:
    """Network label space -> CaDIS paper label space (ignore back to 255)."""
    if taxonomy.task_has_ignore(task):
        mask = np.where(mask == taxonomy.TASK_NUM_CLASSES[task],
                        taxonomy.IGNORE_VALUE, mask)
    return mask


def mask_to_colormap(mask: np.ndarray, task: int) -> np.ndarray:
    """Network-space id mask (HW) -> RGB uint8 (HW3) via the CaDIS colormap."""
    cmap = taxonomy.task_colormap(task)
    return cmap[np.clip(mask, 0, len(cmap) - 1)]
