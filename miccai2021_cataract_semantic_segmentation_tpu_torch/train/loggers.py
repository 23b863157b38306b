"""Observability: TensorBoard scalars, images and figures, and a step timer.

Port of `TBLogger`, `confusion_matrix_figure` and `StepTimer` from the JAX
package's train/loggers.py. `TBLogger` writes through
`torch.utils.tensorboard` where tensorboard imports, else scalars to
`scalars.jsonl` (images and figures are then dropped); the figure is drawn
with matplotlib where it imports, else it is None. Neither package is
needed to run.
"""
from __future__ import annotations

import json
import pathlib
import time

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy


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
