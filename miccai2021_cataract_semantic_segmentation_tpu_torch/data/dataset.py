"""Frame datasets: the host side of the input pipeline.

Port of `SegDataset` and `ArrayDataset` from the JAX package's
data/dataset.py, with its cv2 decode replaced by the port's own: a whole
batch decodes and remaps in native/cadis_io.cpp (`load_batch`, libpng on a
thread pool) where that library builds, else per sample with data/png.py.
index -> (img uint8 HWC RGB, lbl uint8 HW in *network* label space, meta);
the canonical -> task remap is a numpy LUT, so the card only ever sees
dense ids. `DECODED` counts the batches each decoder assembled
(`pipeline.assemble_batch` adds to it), so that a run can say which path
it took.

`VideoDataset` streams frames of a list of videos by global frame index
(global index -> (frame u8 RGB, frame index, video index)), resized to
(height, width) by the port's emulation of cv2.resize; `ColorizationDataset`
reads (rgb, grey) sequences of consecutive frames; `SubmissionDataset`
reads a directory of images for a submission. The videos are read by
data/video_io.py (the port's own AVI, or cv2 where it imports); each video
has one reader, opened at its first read, behind the video's own lock.
"""
from __future__ import annotations

import pathlib
import threading

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import native_io, png, video_io
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import resize
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.video_io import (  # noqa: F401
    probed_frame_count)
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


def _read_image(path: pathlib.Path) -> np.ndarray:
    """RGB uint8 of an image file: a PNG by the port's decoder, another
    format through cv2 where it imports."""
    with open(path, "rb") as f:
        is_png = f.read(8) == b"\x89PNG\r\n\x1a\n"
    if is_png or video_io.cv2 is None:
        return png.read_png(path, 3)
    img = video_io.cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(path)
    return np.ascontiguousarray(img[..., ::-1])


class SubmissionDataset:
    """Inference-only dataset over a directory of images: (img, zero label,
    meta with the image's name), the images in name order and resized to
    (height, width) (the reference's DatasetForSubmission)."""

    def __init__(self, image_dir: str, height: int = 540, width: int = 960):
        self.paths = sorted(pathlib.Path(image_dir).iterdir())
        self.height, self.width = height, width

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int):
        img = _read_image(self.paths[idx])
        if img.shape[:2] != (self.height, self.width):
            img = resize(img, (self.width, self.height))
        lbl = np.zeros(img.shape[:2], np.uint8)
        return img, lbl, {"index": idx, "name": self.paths[idx].name}


class _Videos:
    """One reader a video, opened at its first use under the video's lock.
    With `frame_counts` known a reader opens without probing its count;
    `probe` counts every video once and keeps the readers it opened."""

    def __init__(self, video_paths, frame_counts=None):
        self.video_paths = [str(v) for v in video_paths]
        self.frame_counts = None if frame_counts is None else [int(c) for c in frame_counts]
        self._readers: dict[int, object] = {}
        self._locks = [threading.Lock() for _ in self.video_paths]

    def reader(self, vid: int):
        with self._locks[vid]:
            r = self._readers.get(vid)
            if r is None:
                r = self._readers[vid] = video_io.open_reader(
                    self.video_paths[vid],
                    None if self.frame_counts is None else self.frame_counts[vid])
        return r

    def read(self, vid: int, frame_idx: int) -> np.ndarray:
        """Frame `frame_idx` of video `vid`, RGB; the cv2 reader's seek and
        read hold its own lock."""
        return self.reader(vid).read(frame_idx)

    def probe(self) -> list[int]:
        if self.frame_counts is None:
            self.frame_counts = [int(self.reader(v).frame_count)
                                 for v in range(len(self.video_paths))]
        return self.frame_counts


class VideoDataset:
    """Frames of a list of videos by global frame index (the reference's
    Dataset_from_video): index -> (frame u8 RGB resized to (height, width),
    frame index, video index). `frame_counts` skips each video's open and
    probe where the caller knows the decodable counts (readers on several
    threads sharing one outer dataset's probe, train/video.py)."""

    def __init__(self, video_paths: list[str], height: int = 540,
                 width: int = 960, frame_counts: list[int] | None = None):
        self._videos = _Videos(video_paths, frame_counts)
        self.video_paths = self._videos.video_paths
        self.height, self.width = height, width
        self.frame_counts = self._videos.probe()
        self.offsets = np.cumsum([0] + self.frame_counts)

    def __len__(self):
        return int(self.offsets[-1])

    def locate(self, idx: int) -> tuple[int, int]:
        vid = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return vid, int(idx - self.offsets[vid])

    def __getitem__(self, idx: int):
        vid, frame_idx = self.locate(idx)
        frame = self._videos.read(vid, frame_idx)
        if frame.shape[:2] != (self.height, self.width):
            frame = resize(frame, (self.width, self.height))
        return frame, frame_idx, vid


class ColorizationDataset:
    """Sequences of consecutive frames for the self-supervised
    colourisation side project (the reference's colorization_dataset.py):
    index -> (rgb_seq, grey_seq), two (T, H, W, 3) uint8 arrays of
    T = `sequence_length` frames; the grey is the ITU-R 601 product in
    float32, rounded, in three equal channels. Index i is the i-th of every
    video's n - T + 1 starts, in video order."""

    def __init__(self, video_paths: list[str], sequence_length: int = 1,
                 resize: tuple[int, int] | None = None):
        self._videos = _Videos(video_paths)
        self.video_paths = self._videos.video_paths
        self.sequence_length = int(sequence_length)
        self.resize = None if resize is None else tuple(resize)
        counts = self._videos.probe()
        self.n_starts = [max(0, c - self.sequence_length + 1) for c in counts]
        self.offsets = np.cumsum([0] + self.n_starts)

    def __len__(self):
        return int(self.offsets[-1])

    def locate(self, idx: int) -> tuple[int, int]:
        vid = int(np.searchsorted(self.offsets, idx, side="right") - 1)
        return vid, int(idx - self.offsets[vid])

    def __getitem__(self, idx: int):
        vid, start = self.locate(idx)
        weights = np.array([0.299, 0.587, 0.114], np.float32)
        rgb, grey = [], []
        for t in range(self.sequence_length):
            frame = self._videos.read(vid, start + t)
            if self.resize is not None and frame.shape[:2] != self.resize:
                frame = resize(frame, self.resize[::-1])
            g = np.round(frame.astype(np.float32) @ weights).astype(np.uint8)
            rgb.append(frame)
            grey.append(np.repeat(g[..., None], 3, axis=-1))
        return np.stack(rgb), np.stack(grey)
