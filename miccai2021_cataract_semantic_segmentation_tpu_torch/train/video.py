"""Streaming video inference (the reference's BaseManager.demo_infer).

Port of the JAX package's train/video.py: host decode (data/video_io.py
through data/dataset.py:VideoDataset) -> batched inference with the
Trainer's eval step -> argmax to uint8 on the device -> colormap on the
host -> a writer from `video_io.open_writer` (XVID through cv2 where it
imports, else the port's own AVI). Frames are batched
(`video_batch_size`), decode runs ahead on worker threads, and one batch
is in flight on the device while the previous one is written.
"""
from __future__ import annotations

import itertools
import os
import pathlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch.data import video_io
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import VideoDataset
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.remap import mask_to_colormap


def _background_batches(gen, depth: int = 2):
    """Decode ahead on a worker thread, yielding the host batches of `gen`.

    The frames stay on the host: they are written to the output video. If
    the consumer stops early (a writer raises), a stop event is set and the
    worker's bounded put gives up on a timeout instead of blocking, so
    repeated calls in one process leak neither threads nor frames."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    err = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for item in gen:
                if not put(item):
                    return
        except Exception as e:  # noqa: BLE001 - raised again in the consumer
            err.append(e)
        finally:
            put(None)

    threading.Thread(target=work, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is None:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def _decode_chunk(ds: VideoDataset, chunk):
    indices, n_valid = chunk
    frames, vids = [], []
    for j in indices:
        frame, _, vid = ds[int(j)]
        frames.append(frame)
        vids.append(vid)
    return np.stack(frames), np.asarray(vids), n_valid


def _parallel_batches(video_paths, height, width, chunks, workers: int,
                      frame_counts=None):
    """Decode frame batches on `workers` threads, yielding them in order.

    Each thread owns its own VideoDataset (a cv2 capture is stateful), made
    with the caller's probed `frame_counts`, so that its index -> frame
    mapping matches the offsets the chunks were built from and no thread
    opens and probes every container again. A window of workers + 2
    futures keeps decode ahead of the consumer with bounded memory.
    `chunks` is a list of (frame_indices, n_valid) batch descriptors."""
    tls = threading.local()

    def decode(chunk):
        ds = getattr(tls, "ds", None)
        if ds is None:
            ds = tls.ds = VideoDataset(video_paths, height, width,
                                       frame_counts=frame_counts)
        return _decode_chunk(ds, chunk)

    with ThreadPoolExecutor(max_workers=workers) as pool:
        it = iter(chunks)
        window = deque(pool.submit(decode, c)
                       for c in itertools.islice(it, workers + 2))
        while window:
            fut = window.popleft()
            nxt = next(it, None)
            if nxt is not None:
                window.append(pool.submit(decode, nxt))
            yield fut.result()


def discover_videos(data_path: str, video_ids: list[str]) -> list[pathlib.Path]:
    """workflow/test/dev*.mp4 beside the dataset root (BaseManager.py:157-184)."""
    root = pathlib.Path(data_path).parent / "workflow" / "test"
    return [p for p in sorted(root.glob("**/*.mp4")) if p.stem in video_ids]


def _chunks(indices: np.ndarray, batch_size: int) -> list:
    """(frame indices, n_valid) per batch; the tail padded with its last
    frame to the full batch."""
    out = []
    for i in range(0, len(indices), batch_size):
        chunk = indices[i:i + batch_size]
        n_valid = len(chunk)
        if n_valid < batch_size:
            chunk = np.concatenate([chunk, np.full(batch_size - n_valid, chunk[-1])])
        out.append((chunk, n_valid))
    return out


def demo_infer(trainer, video_paths: list[str] | None = None,
               side_by_side: bool | None = None, frame_freq: int | None = None,
               batch_size: int = 8, fps: int = 30,
               decode_workers: int | None = None) -> dict:
    """Segment videos, writing colour-mapped `{stem}_{model}.avi` files to
    the run directory.

    As the reference (BaseManager.py:148-188, 690-741): the
    `demo_video_inference` mode writes input|prediction side by side unless
    the config has the `miccai_demo` key, `video_inference` the prediction
    alone; `frame_freq` (config `demo_frame_freq`) strides the frame ids
    within each video, and every selected frame is written (the tail batch
    is padded, not dropped). Decode runs on `decode_workers` threads (config
    `video_decode_workers`, default min(4, cpu_count)) with a reader each.
    Returns the frames written, the outputs, the codec the writers used and
    the decoders the readers used, and the frames/s over the loop."""
    cfg = trainer.config
    if side_by_side is None:
        side_by_side = (cfg.get("mode", "demo_video_inference")
                        == "demo_video_inference") and "miccai_demo" not in cfg
    if frame_freq is None:
        frame_freq = int(cfg.get("demo_frame_freq", 1))
    if video_paths is None:
        video_paths = discover_videos(cfg["data_path"], cfg.get("video_ids", []))
    if not video_paths:
        raise ValueError("no videos found or given for video inference")
    if decode_workers is None:
        decode_workers = int(cfg.get("video_decode_workers", min(4, os.cpu_count() or 1)))

    height = int(cfg.get("video_height", 540))
    width = int(cfg.get("video_width", 960))
    readers0 = dict(video_io.READERS)
    ds = VideoDataset(video_paths, height, width)
    # a stride within each video (frame_ids[0::freq] per capture)
    indices = np.concatenate([
        np.arange(ds.offsets[v], ds.offsets[v + 1], frame_freq)
        for v in range(len(video_paths))]).astype(np.int64)
    chunks = _chunks(indices, batch_size)
    model_name = (cfg.get("graph") or {}).get("model", "model")
    shape = (2 * width, height) if side_by_side else (width, height)
    outputs = [trainer.run_dir / f"{pathlib.Path(p).stem}_{model_name}.avi"
               for p in video_paths]
    writers = {}
    n_frames = 0
    dummy_lbl = np.zeros((batch_size, height, width), np.uint8)
    on_card = trainer.device.type == "cuda"

    def flush(pred, done, frames_np, vids, n_valid):
        """Write one batch: its uint8 map (copied to the host behind the
        batch's work), the reflect-pad rows cropped here."""
        nonlocal n_frames
        if done is not None:
            done.synchronize()
        preds = pred.numpy()
        off = (preds.shape[1] - height) // 2
        if off:
            preds = preds[:, off:off + height]
        for k in range(n_valid):
            colour = mask_to_colormap(preds[k], trainer.task)
            out = np.concatenate([frames_np[k], colour], axis=1) if side_by_side else colour
            writers[int(vids[k])].write(out)
            n_frames += 1

    if decode_workers > 1:
        batch_iter = _parallel_batches(video_paths, height, width, chunks,
                                       decode_workers, frame_counts=ds.frame_counts)
    else:
        batch_iter = _background_batches((_decode_chunk(ds, c) for c in chunks), depth=2)

    pending = None
    t0 = time.perf_counter()
    try:
        for vid, path in enumerate(outputs):
            writers[vid] = video_io.open_writer(path, fps, shape)
        for frames, vids, n_valid in batch_iter:
            logits, _, _ = trainer.eval_step(trainer.model, frames, dummy_lbl)
            # argmax and the uint8 cast on the device: one byte a pixel
            # crosses to the host
            with torch.inference_mode():
                pred_dev = logits.argmax(dim=1).to(torch.uint8)
            if on_card:
                pred = torch.empty(pred_dev.shape, dtype=torch.uint8, pin_memory=True)
                pred.copy_(pred_dev, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                pred, done = pred_dev, None
            if pending is not None:
                flush(*pending)      # host work while this batch runs
            pending = (pred, done, frames, vids, n_valid)
        if pending is not None:
            flush(*pending)
    finally:
        for w in writers.values():
            w.release()
    dt = time.perf_counter() - t0
    codecs = sorted({w.codec for w in writers.values()})
    readers = {k: video_io.READERS[k] - readers0[k] for k in video_io.READERS}
    print(f"[video] wrote {n_frames} frames across {len(writers)} videos to "
          f"{trainer.run_dir} (codec {', '.join(codecs)}; readers {readers}; "
          f"{n_frames / dt:.3f} frames/s)")
    return {"frames": n_frames, "outputs": [str(p) for p in outputs],
            "codec": codecs, "readers": readers, "frames_per_sec": n_frames / dt,
            "side_by_side": bool(side_by_side), "frame_freq": frame_freq}
