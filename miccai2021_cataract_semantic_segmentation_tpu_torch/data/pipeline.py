"""Batch pipeline: index batches -> uint8 host batches -> tensors on the
device, with background-thread prefetch.

Port of `pad_or_trim_batches`, `assemble_batch`, `Prefetcher`,
`epoch_iterator` and `eval_batches` from the JAX package's
data/pipeline.py. The host assembles raw uint8 batches (the augmentation
runs on the card, ops/augment.py); a worker thread assembles the next
batches into pinned host memory and copies them to the card on a side
stream while the current one runs. The consumer's stream waits on the
copy's event and each tensor is recorded on that stream, so a batch is
neither read before it lands nor freed while it is in use. A train
pipeline's host transforms (data/transforms.py) run per sample on the
worker thread, each sample with its own generator seeded from the epoch's.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import DECODED


def pad_or_trim_batches(batches: np.ndarray, steps: int | None) -> np.ndarray:
    """(n, B) index batches -> exactly `steps` batches by wrap-around."""
    if steps is None or len(batches) == steps:
        return batches
    if len(batches) > steps:
        return batches[:steps]
    reps = -(-steps // max(len(batches), 1))
    return np.concatenate([batches] * reps)[:steps]


def assemble_batch(dataset, indices, pipeline=None,
                   rng: np.random.Generator | None = None, rows: slice | None = None):
    """Stack dataset items into (images u8 NHWC, labels u8 NHW, idx i32 N).

    Where no host transform is active and the dataset has `load_batch`
    (SegDataset's native decode and remap of a whole batch) and it gives a
    batch, that is the batch; otherwise each sample is read from the
    dataset in turn (data/png.py for a SegDataset), as the JAX package
    reads them, and goes through `pipeline`'s host transforms with its own
    `np.random.default_rng(seed)`, the seeds drawn from `rng` up front
    (`rng.integers(0, 2**63 - 1, len(indices))`; 0, 1, ... without `rng`).
    `rows` (a data-parallel rank's rows, parallel/dist.py) assembles only
    those rows of the batch, each with the seed it has in the whole batch,
    so the ranks together assemble the one-process batch (the role of JAX
    `device_put_batch`). `dataset.DECODED` counts the batches of each
    decoder."""
    host_tf = pipeline is not None and pipeline.host_train
    seeds = None
    if host_tf:
        seeds = rng.integers(0, 2**63 - 1, size=len(indices)) if rng is not None \
            else np.arange(len(indices))
    if rows is not None:
        indices = np.asarray(indices)[rows]
        seeds = None if seeds is None else seeds[rows]
    native = dataset.load_batch(indices) \
        if not host_tf and hasattr(dataset, "load_batch") else None
    if native is not None:
        DECODED["native"] += 1
        imgs, lbls = native
        return imgs, lbls, np.asarray(indices, dtype=np.int32)

    items = [dataset[int(i)][:2] for i in indices]
    if host_tf:
        items = [pipeline.apply_host(img, lbl, np.random.default_rng(seed))
                 for (img, lbl), seed in zip(items, seeds)]
    if getattr(dataset, "decodes", False):
        DECODED["png"] += 1
    return (np.stack([it[0] for it in items]), np.stack([it[1] for it in items]),
            np.asarray(indices, dtype=np.int32))


def eval_batches(n: int, bs: int) -> tuple[np.ndarray, int]:
    """Index batches covering ALL n records at batch size bs.

    The tail batch is padded by repeating the last record; returns
    (batches, n_pad) so the caller can mask the padded rows out of the
    confusion matrix (labels set to 255 count nowhere)."""
    n_full = (n // bs) * bs
    batches = np.arange(n_full).reshape(-1, bs)
    n_pad = 0
    if n_full < n:
        n_pad = bs - (n - n_full)
        tail = np.concatenate([np.arange(n_full, n),
                               np.full((n_pad,), n - 1, dtype=np.int64)])
        batches = np.concatenate([batches, tail[None]], axis=0)
    return batches, n_pad


def to_device(batch, device: torch.device, stream=None):
    """Host arrays -> tensors on `device`: through pinned memory and a
    non-blocking copy on `stream` for a CUDA device (with the event that
    marks the copies done), as they are for the CPU (event None)."""
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in batch]
    if device.type != "cuda":
        return tuple(tensors), None
    with torch.cuda.stream(stream):
        out = tuple(t.pin_memory().to(device, non_blocking=True) for t in tensors)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


class Prefetcher:
    """Assembles and copies batches on a worker thread, keeping up to
    `depth` device batches in flight. A worker's exception re-raises at the
    consumer; `close()` stops the worker."""

    def __init__(self, batch_iter: Iterator, device: torch.device, depth: int = 2):
        self.device = device
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self.thread = threading.Thread(target=self._work, args=(batch_iter,),
                                       daemon=True)
        self.thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, batch_iter):
        try:
            for b in batch_iter:
                if not self._put(to_device(b, self.device, self._stream)):
                    return
        except Exception as e:  # surface worker errors at the consumer
            self._err = e
        finally:
            self._put(None)

    def __iter__(self):
        stream = torch.cuda.current_stream(self.device) if self._stream else None
        while True:
            item = self.q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            tensors, event = item
            if event is not None:
                stream.wait_event(event)
                for t in tensors:
                    t.record_stream(stream)
            yield tensors

    def close(self, timeout: float = 60.0) -> None:
        self._stop.set()
        self.thread.join(timeout)


def epoch_iterator(dataset, batches, device: str | torch.device = "cuda",
                   prefetch: int = 2, pipeline=None, seed: int = 0,
                   rows: slice | None = None):
    """Yield (images u8 NHWC, labels u8 NHW, idx i32) tensors on `device`
    for each index batch of `batches`, in order, or for its `rows` alone
    (`assemble_batch`); `pipeline`'s host transforms draw from
    `np.random.default_rng(seed)` (the Trainer's seed plus the epoch, so a
    resumed epoch draws what it drew)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def gen():
        for idx in batches:
            yield assemble_batch(dataset, idx, pipeline, rng, rows)

    if prefetch > 0:
        pf = Prefetcher(gen(), dev, depth=prefetch)
        try:
            yield from pf
        finally:
            pf.close()
    else:
        for b in gen():
            tensors, _ = to_device(b, dev, torch.cuda.current_stream(dev)
                                   if dev.type == "cuda" else None)
            yield tensors
