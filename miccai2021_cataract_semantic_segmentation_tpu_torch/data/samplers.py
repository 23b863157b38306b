"""Class-imbalance sampling: host-side index streams in numpy.

Port of the JAX package's data/samplers.py, reading the port's
`FrameTable` (data/dataframe.py) where that one reads a pandas frame. The
generators, their seeds and the order of their calls are the JAX
package's, so every index stream is bit-equal to its stream for equal
seeds:
  * repeat-factor sampling: r(c) = max(1, sqrt(t / f(c))),
    r(I) = max over the classes c in I of r(c), rounded stochastically each
    epoch (the reference's utils/repeat_factor_sampling.py);
  * oversampling: the top class-content frames of a preset's classes,
    appended until a fraction of the set (BaseManager.py:326-349);
  * weighted-random: per-image weights from class incidence, modes v1/v2
    (BaseManager.py:350-378);
  * adaptive batching: per-class quotas from a softmax of the live
    (1 - IoU), frames picked by class-content rank
    (utils/adaptive_sampling.py).
"""
from __future__ import annotations

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (
    FrameTable, task_count_matrix)


# ---------------------------------------------------------------------------
# Repeat-factor sampling
# ---------------------------------------------------------------------------

def class_repeat_factors(train_df: FrameTable, repeat_thresh: float,
                         task: int) -> tuple[np.ndarray, np.ndarray]:
    """(freqs, rfs) per task class (the ignore slot last for tasks 2/3).

    f(c) sums, over the canonical members of c, the share of frames that
    hold the member (each member counted apart, as the reference
    accumulates per canonical class, repeat_factor_sampling.py:22-27); a
    class of frequency 0 gets f = t; r(c) = max(1, sqrt(t / f(c)))."""
    present = task_count_matrix(train_df, 0) > 0
    n_frames = len(train_df)
    n_out = taxonomy.num_label_values(task)
    freqs = np.zeros(n_out)
    for task_id, canon_ids in taxonomy.TASK_GROUPS[task].items():
        col = n_out - 1 if task_id == taxonomy.IGNORE_VALUE else task_id
        freqs[col] += present[:, list(canon_ids)].sum() / n_frames
    freqs = np.where(freqs == 0, repeat_thresh, freqs)
    rfs = np.maximum(1.0, np.sqrt(repeat_thresh / freqs))
    return freqs, rfs


def image_repeat_factors(train_df: FrameTable, cls_rfs: np.ndarray,
                         task: int) -> np.ndarray:
    """r(I) = max over the task classes present in frame I of r(c)."""
    present = task_count_matrix(train_df, task) > 0
    return np.where(present, cls_rfs[None, :present.shape[1]], 0.0).max(axis=1)


class RepeatFactorSampler:
    """A shuffled index stream per epoch, each frame repeated r(I) times
    rounded stochastically, so an epoch's length varies as the reference's
    does (repeat_factor_sampling.py:102-131). Blacklisted rows are dropped
    first where `blacklist` is set; the indices are then positions among
    the rows kept, as the JAX package's are."""

    def __init__(self, train_df: FrameTable, repeat_thresh: float, task: int,
                 blacklist: bool = True, seed: int = 1):
        df = train_df
        if blacklist and "blacklisted" in df:
            df = df.select(df["blacklisted"] != 1)
        self.class_freqs, self.class_rfs = class_repeat_factors(df, repeat_thresh, task)
        self.repeat_factors = image_repeat_factors(df, self.class_rfs, task)
        self._int = np.trunc(self.repeat_factors)
        self._frac = self.repeat_factors - self._int
        self.rng = np.random.default_rng(seed)

    def epoch_indices(self) -> np.ndarray:
        rounded = self._int + (self.rng.random(len(self._frac)) < self._frac)
        idx = np.repeat(np.arange(len(rounded)), rounded.astype(np.int64))
        return self.rng.permutation(idx)

    def epoch_batches(self, batch_size: int) -> np.ndarray:
        """(n_batches, batch_size), the last partial batch dropped
        (BaseManager.py:388-391)."""
        idx = self.epoch_indices()
        n = len(idx) // batch_size
        return idx[: n * batch_size].reshape(n, batch_size)


# ---------------------------------------------------------------------------
# Oversampling
# ---------------------------------------------------------------------------

def oversample_indices(train_df: FrameTable, task: int,
                       preset: str = "default", frac: float = 0.2) -> np.ndarray:
    """Row indices to append: the top class-content frames of each preset
    class, widened until at least frac * len(df) distinct rows
    (BaseManager.py:331-342)."""
    class_list = taxonomy.OVERSAMPLING_PRESETS[preset][task]
    counts = task_count_matrix(train_df, task)
    required = int(len(train_df) * frac)
    sel_per_class = max(1, required // len(class_list))
    chosen: np.ndarray = np.array([], dtype=np.int64)
    while len(chosen) < required:
        picks = [np.argsort(-counts[:, c], kind="stable")[:sel_per_class]
                 for c in class_list]
        chosen = np.unique(np.concatenate(picks))
        sel_per_class += max(1, (required - len(chosen)) // len(class_list))
        if sel_per_class >= len(train_df):
            break
    return chosen


# ---------------------------------------------------------------------------
# Weighted-random sampling
# ---------------------------------------------------------------------------

def weighted_random_weights(train_df: FrameTable, task: int,
                            mode: str = "v1") -> np.ndarray:
    """Per-image sampling weights (BaseManager.py:352-372)."""
    n_real = taxonomy.TASK_NUM_CLASSES[task]
    class_abs = task_count_matrix(train_df, task)[:, :n_real]
    class_sum = class_abs.sum(axis=0)
    class_freq = class_sum / class_abs.sum()
    if mode == "v1":
        w = 1.0 / class_freq
        w /= w.sum()
        return (class_abs * w[None]).sum(axis=1)
    if mode == "v2":
        rel = class_abs / np.where(class_sum == 0, 1.0, class_sum)[None]
        return (rel * (1.0 - class_freq)[None]).sum(axis=1)
    raise ValueError(f"weighted_random_mode '{mode}' not recognised")


def weighted_random_epoch(weights: np.ndarray, n: int,
                          rng: np.random.Generator) -> np.ndarray:
    """n indices drawn with replacement in proportion to `weights` (torch's
    WeightedRandomSampler(replacement=True))."""
    p = weights / weights.sum()
    return rng.choice(len(weights), size=n, replace=True, p=p)


# ---------------------------------------------------------------------------
# Adaptive batching
# ---------------------------------------------------------------------------

def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


class AdaptiveBatchSampler:
    """Batches biased toward the classes of low IoU
    (utils/adaptive_sampling.py:8-61); the Trainer feeds the live per-class
    IoU through `update_iou` (an EMA, OCRNet_Manager.py:114-117)."""

    def __init__(self, train_df: FrameTable, task: int, batch_size: int,
                 sel_size: int = 10, dist_type: str = "1-**2",
                 iou_update: float = 1.0, seed: int = 0):
        self.counts = task_count_matrix(train_df, task)
        n_real = taxonomy.TASK_NUM_CLASSES[task]
        self.sort_orders = np.argsort(-self.counts[:, :n_real], axis=0, kind="stable")
        self.n = len(train_df)
        self.batch_size = batch_size
        self.sel_size = sel_size
        self.dist_type = dist_type
        self.iou_update = iou_update
        self.iou_values = np.full(n_real, 0.5, np.float32)
        self.rng = np.random.default_rng(seed)

    def update_iou(self, per_class_iou: np.ndarray) -> None:
        a = self.iou_update
        self.iou_values = (1 - a) * self.iou_values + a * np.asarray(per_class_iou)

    def _probabilities(self) -> np.ndarray:
        iou = self.iou_values.copy()
        if self.dist_type == "1/":
            iou[iou > 0] = iou[iou > 0] ** -1
            return _softmax(iou)
        if self.dist_type == "1-":
            return _softmax(1 - iou)
        if self.dist_type == "1-**2":
            return _softmax((1 - iou) ** 2)
        raise KeyError(f"dist_type '{self.dist_type}' not recognised")

    def _quotas(self, prob: np.ndarray) -> np.ndarray:
        nums = self.batch_size * prob
        quota = np.zeros_like(prob, dtype=np.int64)
        allocated = 0
        for i in np.argsort(prob)[::-1]:
            take = int(min(self.batch_size - allocated, np.ceil(nums[i])))
            quota[i] = take
            allocated += take
            if allocated == self.batch_size:
                break
        return quota

    def next_batch(self) -> np.ndarray:
        idx = []
        for c, d in enumerate(self._quotas(self._probabilities())):
            if d > 0:
                # d groups of sel_size random positions; each group's least
                # position indexes the class-content-sorted frames. Without
                # replacement as the reference draws, unless a small set
                # has fewer frames than draws
                k = d * self.sel_size
                pos = self.rng.choice(self.n, size=k, replace=k > self.n)
                pos = pos.reshape(d, -1).min(axis=1)
                idx.extend(self.sort_orders[pos, c].tolist())
        return np.asarray(idx[: self.batch_size], dtype=np.int64)

    def epoch_batches(self) -> np.ndarray:
        return np.stack([self.next_batch() for _ in range(self.n // self.batch_size)])
