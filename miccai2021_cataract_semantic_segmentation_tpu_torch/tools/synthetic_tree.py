"""A synthetic CaDIS directory tree for runs without the dataset.

`write_tree(root, images, labels, videos)` writes each frame as
<root>/VideoNN/Images/VideoN_frameXXXXXX.png with its canonical-id label
under .../Labels/ (data/png.py's encoder, every filter type: frame i's
image rows use filter i % 5, its label rows all five in turn), and
<root>/data.csv with the columns of the repo's data/data.csv (the
per-canonical-class pixel counts computed from the labels). The port's
`load_frame_table(data_path=root)` then finds that table first, and
`split_dataframes` sorts the frames by their videos.
"""
from __future__ import annotations

import csv
import pathlib

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.png import write_png

COLUMNS = ("", "img_path", "lbl_path", "blacklisted", "comment", "relabeled",
           "folder_name", "file_name", *taxonomy.CANONICAL_NAMES, "ssim", "blpx",
           "per_video_index", "vid_num")


def canonical_from_network(labels: np.ndarray, task: int) -> np.ndarray:
    """Network-space task labels -> canonical ids that remap back to them:
    each class's last canonical member, the ignore id its group's last."""
    lut = np.zeros(taxonomy.num_label_values(task), np.uint8)
    for task_id, canon_ids in taxonomy.TASK_GROUPS[task].items():
        col = taxonomy.TASK_NUM_CLASSES[task] if task_id == taxonomy.IGNORE_VALUE \
            else task_id
        lut[col] = canon_ids[-1]
    return lut[labels]


def write_tree(root, images: np.ndarray, labels: np.ndarray, videos,
               level: int = 1) -> pathlib.Path:
    """Write uint8 RGB `images` (n, H, W, 3) and canonical-id `labels`
    (n, H, W), frame i in video `videos[i]`, and data.csv; returns the
    table's path."""
    root = pathlib.Path(root)
    rows, per_video = [], {}
    for i, (img, lbl, vid) in enumerate(zip(images, labels, videos)):
        k = per_video[vid] = per_video.get(vid, -1) + 1
        folder, name = f"Video{vid:02d}", f"Video{vid}_frame{10 * k:06d}.png"
        for sub, pixels, filt in (("Images", img, i % 5),
                                  ("Labels", lbl, (np.arange(lbl.shape[0]) + i) % 5)):
            (root / folder / sub).mkdir(parents=True, exist_ok=True)
            write_png(root / folder / sub / name, pixels, filt, level)
        counts = np.bincount(lbl.reshape(-1), minlength=taxonomy.NUM_CANONICAL)
        rows.append([i, f"{folder}/Images/{name}", f"{folder}/Labels/{name}", 0,
                     "", "", folder, name,
                     *counts[:taxonomy.NUM_CANONICAL].tolist(), 0, 0, k, vid])
    path = root / "data.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(COLUMNS)
        w.writerows(rows)
    return path
