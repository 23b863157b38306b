"""Observability: TensorBoard scalars, images and figures, a trace of
steps, and a step timer.

Port of `TBLogger`, `confusion_matrix_figure`, `index_histogram_figure`,
`profile_steps` and `StepTimer` from the JAX package's train/loggers.py.
`TBLogger` writes through `torch.utils.tensorboard` where tensorboard
imports, else scalars to `scalars.jsonl` (images and figures are then
dropped); the figures are drawn with matplotlib where it imports, else
they are None. Neither package is needed to run. `profile_steps` traces a
block with `torch.profiler` in place of `jax.profiler`.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import time

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy


class NullLogger:
    """TBLogger's interface, writing nothing (the ranks other than 0)."""

    def __init__(self, log_dir=None):
        pass

    def scalar(self, tag, value, step):
        pass

    def scalars(self, values, step, prefix=""):
        pass

    def image(self, tag, img_hwc_u8, step):
        pass

    def figure(self, tag, fig, step):
        pass

    def flush(self):
        pass

    def close(self):
        pass


class TBLogger:
    def __init__(self, log_dir):
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._w = None
            self._jsonl = open(self.log_dir / "scalars.jsonl", "a")
        else:
            self._w = SummaryWriter(str(self.log_dir))
            self._jsonl = None

    def scalar(self, tag: str, value, step: int):
        v = float(np.asarray(value))
        if self._w is not None:
            self._w.add_scalar(tag, v, step)
        else:
            self._jsonl.write(json.dumps({"tag": tag, "value": v, "step": step,
                                          "t": time.time()}) + "\n")
            self._jsonl.flush()

    def scalars(self, values: dict, step: int, prefix: str = ""):
        for k, v in values.items():
            if np.asarray(v).ndim == 0:
                self.scalar(f"{prefix}{k}", v, step)

    def image(self, tag: str, img_hwc_u8: np.ndarray, step: int):
        if self._w is not None:
            self._w.add_image(tag, img_hwc_u8, step, dataformats="HWC")

    def figure(self, tag: str, fig, step: int):
        if self._w is not None and fig is not None:
            self._w.add_figure(tag, fig, step)

    def flush(self):
        if self._w is not None:
            self._w.flush()

    def close(self):
        if self._w is not None:
            self._w.close()
        if self._jsonl is not None:
            self._jsonl.close()


def confusion_matrix_figure(matrix: np.ndarray, task: int):
    """Heatmap figure of a normalised confusion matrix; None without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    labels = list(taxonomy.TASK_CLASS_NAMES[task])
    if matrix.shape[0] > len(labels):
        labels = labels + ["Ignore"]
    n = matrix.shape[0]
    fig, ax = plt.subplots(figsize=(0.45 * n + 2, 0.45 * n + 2))
    im = ax.imshow(matrix, cmap="YlGn", vmin=0, vmax=1)
    ax.set_xticks(range(n), labels[:n], rotation=90, fontsize=6)
    ax.set_yticks(range(n), labels[:n], fontsize=6)
    fig.colorbar(im, ax=ax, fraction=0.046)
    for i in range(n):
        for j in range(n):
            if matrix[i, j] > 0.005:
                ax.text(j, i, f"{matrix[i, j]:.2f}", ha="center", va="center",
                        fontsize=5,
                        color="white" if matrix[i, j] > 0.6 else "black")
    fig.tight_layout()
    return fig


def index_histogram_figure(counts: np.ndarray, bins: int = 50):
    """Bar chart of how often each sample was drawn, in `bins` bins of
    sample indices (the reference's utils/utils.py:547-574
    fig_from_dist); None without matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    per_bin = max(len(counts) // bins, 1)
    n = len(counts) // per_bin
    agg = counts[: n * per_bin].reshape(n, per_bin).sum(axis=1)
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.bar(range(n), agg)
    ax.set_xlabel("sample index bin")
    ax.set_ylabel("times sampled")
    fig.tight_layout()
    return fig


@contextlib.contextmanager
def profile_steps(run_dir, device):
    """A `torch.profiler` trace of the block, the host's activity and, on a
    CUDA `device`, the card's kernels, written as a Chrome trace to
    <run_dir>/profile/trace.json when the block ends; yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(run_dir) / "profile"
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Rolling wall-clock step timing (host-side, no device syncs)."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: list[float] = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def mean_ms(self) -> float:
        return 1000 * float(np.mean(self.times)) if self.times else 0.0
