"""Frame datasets: the host side of the input pipeline.

Port of `SegDataset` and `ArrayDataset` from the JAX package's
data/dataset.py, with its cv2 decode replaced by the port's own: a whole
batch decodes and remaps in native/cadis_io.cpp (`load_batch`, libpng on a
thread pool) where that library builds, else per sample with data/png.py.
index -> (img uint8 HWC RGB, lbl uint8 HW in *network* label space, meta);
the canonical -> task remap is a numpy LUT, so the card only ever sees
dense ids. `DECODED` counts the batches each decoder assembled
(`pipeline.assemble_batch` adds to it), so that a run can say which path
it took. `VideoDataset`, `SubmissionDataset` and `ColorizationDataset`
come with video inference (ROADMAP Queue A item 13).
"""
from __future__ import annotations

import pathlib

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import native_io, png
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.remap import remap_mask_np

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]

# batches assembled by each decoder since import (or the last reset)
DECODED = {"native": 0, "png": 0}


def reset_decoded() -> None:
    for k in DECODED:
        DECODED[k] = 0


def _normalise_rel_path(p: str) -> pathlib.PurePosixPath:
    """The frame table may hold Windows-style separators."""
    return pathlib.PurePosixPath(str(p).replace("\\", "/"))


class SegDataset:
    def __init__(self, df, task: int, data_path: str | None = None,
                 preload: bool = False):
        self.df = df
        self.task = task
        self.data_path = pathlib.Path(data_path) if data_path else None
        self._cache: dict[int, tuple[np.ndarray, np.ndarray]] | None = None
        if preload:
            self._cache = {i: self._load(i) for i in range(len(df))}

    def __len__(self):
        return len(self.df)

    def _resolve(self, rel: str) -> pathlib.Path:
        rel = _normalise_rel_path(rel)
        p = (self.data_path / rel) if self.data_path else pathlib.Path(rel)
        # use_relabeled rewrites lbl_path to relabeled/<name>; the 40
        # corrected labels also ship in <repo>/relabelled/, used where the
        # dataset tree has no copy
        if not p.is_file() and rel.parts and rel.parts[0] == "relabeled":
            vendored = _REPO_ROOT / "relabelled" / rel.name
            if vendored.is_file():
                return vendored
        return p

    def _load(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        row = self.df.row(idx)
        img = png.read_png(self._resolve(row["img_path"]), 3)
        lbl = png.read_png(self._resolve(row["lbl_path"]), 1)
        return img, remap_mask_np(lbl, self.task, to_network=True)

    def __getitem__(self, idx: int):
        if self._cache is not None:
            img, lbl = self._cache[idx]
        else:
            img, lbl = self._load(idx)
        vid = self.df["vid_num"][idx] if "vid_num" in self.df else -1
        return img, lbl, {"index": idx, "vid_num": int(vid)}

    @property
    def decodes(self) -> bool:
        """True where a sample is decoded from disk when it is read."""
        return self._cache is None

    def load_batch(self, indices) -> tuple[np.ndarray, np.ndarray] | None:
        """Decode and remap a whole batch in native code (C++ thread pool);
        None where that library is unavailable, the files are not PNGs or
        the set is preloaded."""
        if self._cache is not None or not native_io.available():
            return None
        rows = [self.df.row(int(i)) for i in indices]
        img_paths = [self._resolve(r["img_path"]) for r in rows]
        lbl_paths = [self._resolve(r["lbl_path"]) for r in rows]
        if not str(img_paths[0]).lower().endswith(".png"):
            return None
        h, w = png.png_dimensions(img_paths[0])
        lut = np.asarray(taxonomy.REMAP_LUTS_NETWORK[self.task], np.uint8)
        return native_io.load_batch(img_paths, lbl_paths, h, w, lut)


class ArrayDataset:
    """In-memory dataset (synthetic data, tests) with SegDataset's interface."""

    def __init__(self, images: np.ndarray, labels: np.ndarray):
        if len(images) != len(labels):
            raise ValueError(f"{len(images)} images but {len(labels)} labels")
        self.images, self.labels = images, labels

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx: int):
        return self.images[idx], self.labels[idx], {"index": idx, "vid_num": -1}
