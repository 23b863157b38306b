"""Semi-supervised data helpers (the reference's utils/semi_utis.py).

Port of the JAX package's data/semi.py on the port's own frame table (no
pandas). `BalancedConcatDataset` zips a labelled and an unlabelled dataset
(each index wraps modulo each member's length; the epoch is the longest
member); `SemiSupervisedView` is the Trainer's index-union view of the
labelled set and the unlabelled pool; `video_files_from_split` maps split
video ids to the CaDIS mp4 layout; `excluded_frames_from_df` lists each
video's labelled frames, which the unlabelled pool leaves out;
`unlabeled_from_videos` is the pool of the training split's surgery
videos without those frames, read by data/dataset.py:VideoDataset (each
file's container is sniffed from its bytes, so the port's own AVI under
an .mp4 name serves where cv2 is absent).
"""
from __future__ import annotations

import pathlib
import re
import warnings
from collections import OrderedDict

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import FrameTable

_TRAIN_GROUPS = {
    "train_1": [1, 2, 3, 4, 5, 6, 7, 8],
    "train_2": [9, 10, 11, 12, 13, 14, 15, 16],
    "train_3": [17, 18, 19, 20, 21, 22, 23, 24],
    "train_4": [25],
}


class BalancedConcatDataset:
    """Each item is a tuple with one sample from every member dataset; the
    shorter members wrap around (semi_utis.py:6-23)."""

    def __init__(self, *datasets):
        self.datasets = datasets
        self.max_len = max(len(d) for d in self.datasets)

    def __getitem__(self, i):
        return tuple(d[i % len(d)] for d in self.datasets)

    def __len__(self):
        return self.max_len


class SemiSupervisedView:
    """Index-union view for semi-supervised training.

    Indices [0, len(labeled)) fetch labelled items unchanged; indices
    [len(labeled), len(labeled) + len(unlabeled)) fetch unlabelled images
    with an all-`ignore_id` label plane: the pseudo-labels are made on the
    card inside the train step (train/steps.py). Unlabelled members may
    return bare images, (img, ...) tuples or (img, lbl, meta) items; only
    the image is used."""

    def __init__(self, labeled, unlabeled, ignore_id: int):
        self.labeled = labeled
        self.unlabeled = unlabeled
        self.ignore_id = int(ignore_id)

    def __len__(self):
        return len(self.labeled) + len(self.unlabeled)

    def __getitem__(self, i: int):
        n_lab = len(self.labeled)
        if i < n_lab:
            return self.labeled[i]
        item = self.unlabeled[i - n_lab]
        img = item[0] if isinstance(item, tuple) else item
        lbl = np.full(img.shape[:2], self.ignore_id, np.uint8)
        return img, lbl, {"index": i, "unlabeled": True}

    @property
    def decodes(self) -> bool:
        """True where the labelled member decodes a sample when it is read."""
        return bool(getattr(self.labeled, "decodes", False))

    def load_batch(self, indices):
        """The labelled member's native batch decode for the labelled part
        of a mixed batch (pipeline.assemble_batch probes this hook), the
        unlabelled samples one by one, in order; None (the per-sample path)
        where the labelled member has no native decode."""
        if not hasattr(self.labeled, "load_batch"):
            return None
        idx = np.asarray(indices)
        n_lab = len(self.labeled)
        lab_pos = np.flatnonzero(idx < n_lab)
        native = self.labeled.load_batch(idx[lab_pos]) if len(lab_pos) else None
        if native is None and len(lab_pos):
            return None
        if native is not None:
            li, ll = native
            imgs = np.empty((len(idx), *li.shape[1:]), li.dtype)
            lbls = np.empty((len(idx), *ll.shape[1:]), np.uint8)
            imgs[lab_pos], lbls[lab_pos] = li, ll
        else:
            # an all-unlabelled batch: the shape comes from its first sample
            img0, lbl0, _ = self[int(idx[0])]
            imgs = np.empty((len(idx), *img0.shape), img0.dtype)
            lbls = np.empty((len(idx), *lbl0.shape), np.uint8)
            imgs[0], lbls[0] = img0, lbl0
        fill = np.flatnonzero(idx >= n_lab)
        if native is None:
            fill = fill[fill != 0]
        for k in fill:
            img, lbl, _ = self[int(idx[k])]
            imgs[k], lbls[k] = img, lbl
        return imgs, lbls


class _IndexSubset:
    """View of `base` restricted to `indices` (the unlabelled pool without
    the frames that have ground truth)."""

    def __init__(self, base, indices):
        self.base = base
        self.indices = np.asarray(indices, dtype=np.int64)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.base[int(self.indices[i])]


def unlabeled_from_videos(data_path, train_df: FrameTable,
                          height: int = 540, width: int = 960):
    """The unlabelled pool of the training split's surgery videos under
    `data_path` (semi_utis.py:26-46), without the frames that carry ground
    truth in `train_df` (excluded_frames_from_df, semi_utis.py:49-69)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import (
        VideoDataset)
    ids = sorted(int(v) for v in np.unique(np.asarray(train_df["vid_num"])))
    root = pathlib.Path(data_path or ".")
    files = [root / f for f in video_files_from_split(ids)]
    found = [f for f in files if f.is_file()]
    if not found:
        raise FileNotFoundError(
            f"semi-supervised mode: no training-split videos under {root} "
            f"(looked for {[str(f) for f in files[:3]]}...)")
    if len(found) < len(files):
        missing = [f.name for f in files if not f.is_file()]
        warnings.warn(
            f"semi-supervised mode: {len(missing)} of {len(files)} training-"
            f"split videos missing under {root} ({missing[:5]}...) — the "
            "unlabeled pool covers the found videos only", stacklevel=2)
    vds = VideoDataset([str(f) for f in found], height, width)
    excluded = excluded_frames_from_df(df=train_df, train_videos=ids)
    keep = []
    for v, path in enumerate(found):
        m = re.search(r"train(\d+)\.mp4$", str(path))
        vid_num = int(m.group(1)) if m else -1
        drop = set(excluded.get(vid_num, ()))
        base = int(vds.offsets[v])
        keep.extend(base + f for f in range(vds.frame_counts[v]) if f not in drop)
    return _IndexSubset(vds, keep)


def video_files_from_split(ids, debug: bool = False) -> list[pathlib.Path]:
    """Split video ids -> mp4 paths in the CaDIS video release layout
    (semi_utis.py:26-46)."""
    files = []
    for i in ids:
        for group, members in _TRAIN_GROUPS.items():
            if debug and group != "train_1":
                continue
            if debug and i not in (1, 3, 6):
                continue
            if i in members:
                files.append(pathlib.Path(group) / f"train{i:02d}.mp4")
                break
    return files


def excluded_frames_from_df(df: FrameTable, train_videos: list[int]
                            ) -> "OrderedDict[int, list[int]]":
    """{video id: [labelled frame ids]} of the non-blacklisted frames of
    `train_videos` (semi_utis.py:49-69), in the table's order; a frame's id
    is the number that ends its image file's name."""
    vids = np.asarray(df["vid_num"])
    keep = np.isin(vids, list(train_videos)) & (np.asarray(df["blacklisted"]) != 1)
    out: OrderedDict[int, list[int]] = OrderedDict()
    for vid, path in zip(vids[keep], np.asarray(df["img_path"])[keep]):
        m = re.search(r"(\d+)\.\w+$", str(path))
        out.setdefault(int(vid), []).append(int(m.group(1)) if m else -1)
    return out
