"""The port's video path against the JAX package's cv2 one.

- The port's AVI (data/video_io.py): written and read back bit-equal by
  the port and by cv2 (sequential reads and seeks), at odd widths, at 540x960,
  and across OpenDML segments at a RIFF limit forced small; a frame that
  outgrows the limit raises; the container is sniffed from the bytes; a
  truncated file loses its tail; without cv2 another codec raises naming
  the file, the container and the fourcc.
- `probed_frame_count`, `VideoDataset`, `ColorizationDataset` and
  `SubmissionDataset` bit-equal to the JAX package's on cv2-written XVID,
  on the port's AVI and on PNGs, with and without the resize.
- `unlabeled_from_videos`: the same indices and frames as JAX's on
  cv2-written `train_1/train01.mp4`-style files.
- `demo_infer`, port against JAX, FCN at width 0.125 with the same
  numpy-filled weights in float64 on both sides (the JAX package under
  x64): every written frame equal, captured by writers patched in, side by
  side and prediction-only, `demo_frame_freq` 2, a padded tail batch,
  decode workers 1 and 3; the CLI's two video modes write the port's AVI
  (cv2 hidden from data/video_io.py) equal to the in-process call.
Sizes are cut for the CPU: frames of 48x64 to 60x64, a few frames a video.
"""
import json
import pathlib
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data import dataframe as jax_df
from miccai2021_cataract_semantic_segmentation_tpu.data import dataset as jax_dataset
from miccai2021_cataract_semantic_segmentation_tpu.data import semi as jax_semi
from miccai2021_cataract_semantic_segmentation_tpu.models import build_model as jax_build_model
from miccai2021_cataract_semantic_segmentation_tpu.train import state as jax_state
from miccai2021_cataract_semantic_segmentation_tpu.train import video as jax_video
from miccai2021_cataract_semantic_segmentation_tpu.train.steps import (
    make_eval_step as jax_make_eval_step)

from miccai2021_cataract_semantic_segmentation_tpu_torch.data import dataset, semi, video_io
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import load_frame_table
from miccai2021_cataract_semantic_segmentation_tpu_torch.main import main
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    canonical_from_network, write_tree)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import video
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.bridge import bridge_flax_names
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    EvalSpec, make_eval_step)
from test_torch_eval import numpy_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(n, h, w, seed):
    """Smooth frames with noise: XVID keeps them recognisable."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    out = []
    for k in range(n):
        base = np.stack([(yy * 3 + 20 * k) % 256, (xx * 2 + 7 * k) % 256,
                         (yy + xx + 40 * k) % 256], -1)
        out.append(np.clip(base + rng.integers(-20, 21, (h, w, 3)), 0, 255).astype(np.uint8))
    return out


def write_avi(path, imgs, riff_limit=video_io.RIFF_LIMIT):
    w = video_io.AviWriter(path, 25, imgs[0].shape[1::-1], riff_limit=riff_limit)
    for f in imgs:
        w.write(f)
    w.release()
    return w


def write_cv2(path, imgs, fourcc="XVID"):
    h, w = imgs[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*fourcc), 25, (w, h))
    assert wr.isOpened()
    for f in imgs:
        wr.write(np.ascontiguousarray(f[..., ::-1]))
    wr.release()


def cv2_frames(path):
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            return out
        out.append(f[..., ::-1])


# ------------------------------------------------------------- the port's AVI

@pytest.mark.parametrize("h, w, n, limit, segments", [
    (48, 64, 5, video_io.RIFF_LIMIT, 1),
    (47, 63, 7, video_io.RIFF_LIMIT, 1),      # rows padded to 4 bytes
    (48, 64, 11, 40_000, 3),                  # OpenDML: AVIX segments, indx
    (540, 960, 3, 4_000_000, 2),
])
def test_avi_round_trips_in_the_port_and_in_cv2(tmp_path, h, w, n, limit, segments):
    imgs = [np.random.default_rng(k).integers(0, 256, (h, w, 3), dtype=np.uint8)
            for k in range(n)]
    path = tmp_path / "v.avi"
    wr = write_avi(path, imgs, limit)
    assert wr.codec == "avi_raw" and wr.frames == n and len(wr._segments) == segments
    raw = path.read_bytes()
    assert (b"AVIX" in raw) == (segments > 1) and (b"indx" in raw) == (segments > 1)
    r = video_io.open_reader(path)
    assert isinstance(r, video_io.AviReader) and r.frame_count == n and r.shape == (h, w)
    for i in (n - 1, 0, *range(n)):
        np.testing.assert_array_equal(r.read(i), imgs[i])
    r.close()
    got = cv2_frames(path)
    assert len(got) == n
    for a, b in zip(got, imgs):
        np.testing.assert_array_equal(a, b)
    cap = cv2.VideoCapture(str(path))
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == n
    assert jax_dataset.probed_frame_count(cap) == n
    cap.set(cv2.CAP_PROP_POS_FRAMES, n - 2)
    np.testing.assert_array_equal(cap.read()[1][..., ::-1], imgs[n - 2])


def test_avi_writer_refuses_what_it_cannot_hold(tmp_path):
    wr = video_io.AviWriter(tmp_path / "a.avi", 25, (64, 48), riff_limit=10_000)
    with pytest.raises(IOError, match="RIFF limit of 10000"):
        wr.write(np.zeros((48, 64, 3), np.uint8))
    with pytest.raises(ValueError, match="uint8"):
        wr.write(np.zeros((48, 63, 3), np.uint8))


def test_reader_sniffs_the_container_and_names_what_it_cannot_read(tmp_path, monkeypatch):
    imgs = frames(6, 48, 64, 1)
    write_avi(tmp_path / "port.mp4", imgs)                 # an AVI under an mp4 name
    write_cv2(tmp_path / "xvid.avi", imgs)
    r = video_io.open_reader(tmp_path / "port.mp4")
    assert r.codec == "avi_raw" and r.frame_count == 6
    r = video_io.open_reader(tmp_path / "xvid.avi")
    assert r.codec == "cv2" and r.frame_count == 6
    for i, want in enumerate(cv2_frames(tmp_path / "xvid.avi")):
        np.testing.assert_array_equal(r.read(i), want)
    with pytest.raises(IOError, match="failed to read frame 6"):
        r.read(6)
    (tmp_path / "junk.mp4").write_bytes(b"\0" * 64)
    monkeypatch.setattr(video_io, "cv2", None)
    with pytest.raises(IOError, match="xvid.avi: container avi, fourcc XVID"):
        video_io.open_reader(tmp_path / "xvid.avi")
    with pytest.raises(IOError, match="junk.mp4: container unknown"):
        video_io.open_reader(tmp_path / "junk.mp4")
    assert video_io.open_reader(tmp_path / "port.mp4").frame_count == 6
    assert isinstance(video_io.open_writer(tmp_path / "o.avi", 25, (64, 48)),
                      video_io.AviWriter)


def test_truncated_avi_loses_its_tail(tmp_path):
    imgs = frames(4, 48, 64, 2)
    write_avi(tmp_path / "t.avi", imgs)
    raw = (tmp_path / "t.avi").read_bytes()
    frame_bytes = 48 * 64 * 3
    last = raw.rindex(b"00db", 0, raw.index(b"idx1"))   # the last frame's chunk
    cut = last + 8 + frame_bytes // 2                    # into its pixels, idx1 lost
    (tmp_path / "c.avi").write_bytes(raw[:cut])
    r = video_io.open_reader(tmp_path / "c.avi")
    assert r.frame_count == 3
    np.testing.assert_array_equal(r.read(2), imgs[2])
    with pytest.raises(IOError, match="out of its 3 frames"):
        r.read(3)


# ------------------------------------------------------------ the datasets

@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("videos")
    write_cv2(root / "a.avi", frames(7, 48, 64, 3))
    write_avi(root / "b.avi", frames(5, 60, 64, 4))
    write_cv2(root / "c.mp4", frames(4, 60, 64, 5), "mp4v")
    return [str(root / n) for n in ("a.avi", "b.avi", "c.mp4")]


def test_probed_frame_count_equals_jax(videos):
    for v in videos:
        want = jax_dataset.probed_frame_count(cv2.VideoCapture(v))
        assert dataset.probed_frame_count(cv2.VideoCapture(v)) == want
        assert video_io.open_reader(v).frame_count == want


@pytest.mark.parametrize("hw", [(60, 64), (48, 64), (33, 50)])
def test_video_dataset_equals_jax(videos, hw):
    got = dataset.VideoDataset(videos, *hw)
    want = jax_dataset.VideoDataset(videos, *hw)
    assert got.frame_counts == want.frame_counts == [7, 5, 4]
    np.testing.assert_array_equal(got.offsets, want.offsets)
    assert len(got) == len(want) == 16
    for i in (15, 0, 8, *range(16)):               # seeks back and forth
        assert got.locate(i) == want.locate(i)
        (a, fa, va), (b, fb, vb) = got[i], want[i]
        assert (fa, va) == (fb, vb) and a.shape == (*hw, 3)
        np.testing.assert_array_equal(a, b)
    shared = dataset.VideoDataset(videos, *hw, frame_counts=got.frame_counts)
    np.testing.assert_array_equal(shared[9][0], want[9][0])


def test_video_dataset_reads_right_from_many_threads(videos):
    """One dataset shared by 8 threads (more than the cores the suite gives
    a worker), a short switch interval: the cv2 videos' seek-and-read and
    the AVI's pread give every thread the frames a serial read gives."""
    import sys
    import threading
    ds = dataset.VideoDataset(videos, 60, 64)
    want = [ds[i][0] for i in range(len(ds))]
    ds = dataset.VideoDataset(videos, 60, 64)
    bad, interval = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(seed):
        for i in np.random.default_rng(seed).permutation(len(ds)):
            if not np.array_equal(ds[int(i)][0], want[i]):
                bad.append(int(i))

    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and bad == []


def test_cv2_videos_are_probed_once(videos, monkeypatch):
    """A cv2 video's tail probe (a seek to the tail and decodes) runs once:
    the dataset keeps the readers its probe opened, and the per-thread
    readers of `_parallel_batches` open with the probed counts."""
    probes = []
    real = video_io.probed_frame_count
    monkeypatch.setattr(video_io, "probed_frame_count",
                        lambda cap: probes.append(1) or real(cap))
    ds = dataset.VideoDataset(videos, 60, 64)
    n_cv2 = sum(isinstance(ds._videos.reader(v), video_io.Cv2Reader)
                for v in range(len(videos)))
    assert n_cv2 == 2 and len(probes) == n_cv2
    want = [ds[i][0] for i in range(len(ds))]
    assert len(probes) == n_cv2
    chunks = video._chunks(np.arange(len(ds)), 3)
    got = list(video._parallel_batches(videos, 60, 64, chunks, 3,
                                       frame_counts=ds.frame_counts))
    assert len(probes) == n_cv2
    frames = np.concatenate([f[:n] for f, _, n in got])
    np.testing.assert_array_equal(frames, np.stack(want))
    counted = dataset.VideoDataset(videos, 60, 64, frame_counts=ds.frame_counts)
    np.testing.assert_array_equal(counted[len(ds) - 1][0], want[-1])
    assert len(probes) == n_cv2


@pytest.mark.parametrize("seq, size", [(1, None), (2, None), (3, (40, 56))])
def test_colorization_dataset_equals_jax(videos, seq, size):
    got = dataset.ColorizationDataset(videos, seq, size)
    want = jax_dataset.ColorizationDataset(videos, seq, size)
    assert got.n_starts == want.n_starts and len(got) == len(want) > 0
    for i in range(len(got)):
        assert got.locate(i) == want.locate(i)
        for a, b in zip(got[i], want[i]):
            assert a.dtype == np.uint8 and a.shape[0] == seq
            np.testing.assert_array_equal(a, b)


def test_submission_dataset_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    for k, name in enumerate(["b_2.png", "a_1.png", "c_3.png", "d_4.jpg"]):
        h, w = (60, 64) if k == 0 else (30, 48)
        cv2.imwrite(str(tmp_path / name), rng.integers(0, 255, (h, w, 3), np.uint8))
    got = dataset.SubmissionDataset(str(tmp_path), 60, 64)
    want = jax_dataset.SubmissionDataset(str(tmp_path), 60, 64)
    assert len(got) == len(want) == 4
    for i in range(4):
        (a, la, ma), (b, lb, mb) = got[i], want[i]
        assert ma == mb
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_video_pool_equals_jax(tmp_path):
    """Training videos 1 and 3 of 130 frames (the table labels frames from
    90 on, every 10th), video 2 missing: the same warning, the same kept
    global indices and the same frames."""
    port_table, jax_table = load_frame_table(), jax_df.load_frame_table()
    rows = np.flatnonzero(np.isin(np.asarray(port_table["vid_num"]), [1, 2, 3]))
    port_df, jax_frame = port_table.take(rows), jax_table.iloc[rows]
    for vid in (1, 3):
        (tmp_path / "train_1").mkdir(exist_ok=True)
        write_cv2(tmp_path / "train_1" / f"train{vid:02d}.mp4",
                  frames(130, 32, 48, vid), "mp4v")
    with pytest.warns(UserWarning, match="1 of 3 training-split videos missing"):
        got = semi.unlabeled_from_videos(tmp_path, port_df, 24, 40)
    with pytest.warns(UserWarning, match="1 of 3 training-split videos missing"):
        want = jax_semi.unlabeled_from_videos(tmp_path, jax_frame, 24, 40)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert len(got) == 256 and 90 not in got.indices and 89 in got.indices
    for i in (0, 89, 90, len(got) - 1):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError, match="no training-split videos"):
        semi.unlabeled_from_videos(tmp_path / "none", port_df)


# ------------------------------------------------------------- demo_infer

GRAPH = {"model": "FCN", "width": 0.125}
H, W = 60, 64


class Capture:
    """A writer that keeps the frames it is given, by output name."""
    frames: dict = {}
    codec = "capture"

    def __init__(self, path, *args):
        self.name = pathlib.Path(path).name
        Capture.frames[self.name] = []

    def write(self, img):
        Capture.frames[self.name].append(np.array(img))

    def release(self):
        pass


class JaxCapture(Capture):
    """cv2.VideoWriter's place: BGR frames, kept as RGB."""

    def write(self, img):
        Capture.frames[self.name].append(np.array(img[..., ::-1]))


@pytest.fixture(scope="module")
def demo(tmp_path_factory, videos):
    root = tmp_path_factory.mktemp("demo")
    jax.config.update("jax_enable_x64", True)
    try:
        model = jax_build_model(GRAPH, 2, dtype=jnp.float64)
        variables = jax.tree.map(np.asarray, numpy_variables(model, seed=6))
        state = jax_state.TrainState(step=0, params=variables["params"],
                                     batch_stats=variables.get("batch_stats", {}),
                                     opt_state=(), apply_fn=model.apply, tx=None)
        jax_step = jax_make_eval_step(types.SimpleNamespace(pad=True, normalise=False), 17)
    finally:
        jax.config.update("jax_enable_x64", False)
    port = build_model(GRAPH, 2, device="cpu").double()
    ckpt.load_model_state(port, bridge_flax_names(variables["params"]))
    cfg = {"mode": "demo_video_inference", "graph": GRAPH, "video_height": H,
           "video_width": W, "data_path": str(root / "data")}

    def trainers(extra):
        config = dict(cfg, **extra)
        jt = types.SimpleNamespace(config=config, run_dir=root / "jax", state=state,
                                   eval_step=jax_step, task=2)
        pt = types.SimpleNamespace(
            config=config, run_dir=root / "port", model=port, task=2,
            device=torch.device("cpu"),
            eval_step=make_eval_step(EvalSpec(pad=True), 17, "cpu", "f32"))
        return jt, pt

    return trainers, port


def _captured(monkeypatch, fn, writer_cls, target, attr):
    Capture.frames = {}
    monkeypatch.setattr(target, attr, writer_cls)
    try:
        out = fn()
    finally:
        monkeypatch.undo()
    return out, Capture.frames


@pytest.mark.parametrize("side, freq, workers, batch", [
    (True, 1, 1, 5), (False, 2, 3, 3), (True, 2, 3, 4), (False, 1, 1, 16)])
def test_demo_infer_writes_the_frames_jax_writes(demo, videos, monkeypatch, side, freq,
                                                 workers, batch):
    trainers, _ = demo
    jt, pt = trainers({"demo_frame_freq": freq} if freq != 1 else {})
    shim = types.SimpleNamespace(VideoWriter=JaxCapture, VideoWriter_fourcc=cv2.VideoWriter_fourcc,
                                 cvtColor=cv2.cvtColor, COLOR_RGB2BGR=cv2.COLOR_RGB2BGR)
    jax.config.update("jax_enable_x64", True)
    try:
        n_jax, want = _captured(monkeypatch, lambda: jax_video.demo_infer(
            jt, videos, side_by_side=side, batch_size=batch, decode_workers=workers),
            shim, jax_video, "cv2")
    finally:
        jax.config.update("jax_enable_x64", False)
    res, got = _captured(monkeypatch, lambda: video.demo_infer(
        pt, videos, side_by_side=side, batch_size=batch, decode_workers=workers),
        Capture, video_io, "open_writer")
    counts = [len(range(0, n, freq)) for n in (7, 5, 4)]
    assert res["frames"] == n_jax == sum(counts)
    assert sorted(got) == sorted(want) == ["a_FCN.avi", "b_FCN.avi", "c_FCN.avi"]
    assert res["codec"] == ["capture"] and res["side_by_side"] == side
    for name, n in zip(("a_FCN.avi", "b_FCN.avi", "c_FCN.avi"), counts):
        assert len(got[name]) == len(want[name]) == n
        for a, b in zip(got[name], want[name]):
            assert a.shape == (H, 2 * W if side else W, 3)
            np.testing.assert_array_equal(a, b)


def test_cli_video_modes_write_the_port_avi(demo, videos, tmp_path, monkeypatch):
    """Both video modes through the CLI (cv2 hidden: the port's AVI), the
    checkpoint restored from `load_checkpoint`: each output read back by
    the port equals the in-process call's frames on the same float32
    model; `discover_videos` finds workflow/test's mp4s by stem."""
    _, port = demo
    model = build_model(GRAPH, 2, device="cpu")
    model.load_state_dict({k: v.float() for k, v in port.state_dict().items()})
    ckpt.save_checkpoint(tmp_path / "logs" / "pub" / "chkpts", "best", model, 0, 0.0, 0.0)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, 18, (3, H, W)).astype(np.uint8)
    write_tree(tmp_path / "cadis" / "data", frames(3, H, W, 9),
               canonical_from_network(labels, 2), [2, 12, 22])
    test_dir = tmp_path / "cadis" / "workflow" / "test" / "group"
    test_dir.mkdir(parents=True)
    for stem, src in (("dev01", videos[1]), ("skip", videos[1])):
        (test_dir / f"{stem}.mp4").write_bytes(pathlib.Path(src).read_bytes())
    write_avi(test_dir / "dev02.mp4", frames(4, 48, 64, 8))      # resized to 60x64
    found = video.discover_videos(str(tmp_path / "cadis" / "data"), ["dev01", "dev02"])
    assert [p.stem for p in found] == ["dev01", "dev02"]
    cfg = json.loads((ROOT / "configs" / "OCRNet_pretrained_t2.json").read_text())
    cfg.update(graph=GRAPH, precision="f32", log_path=str(tmp_path / "logs"),
               load_checkpoint="pub", video_ids=["dev01", "dev02"], video_height=H,
               video_width=W, demo_frame_freq=2)
    monkeypatch.setattr(video_io, "cv2", None)
    pt = types.SimpleNamespace(config=None, run_dir=tmp_path / "inproc", model=model,
                               task=2, device=torch.device("cpu"),
                               eval_step=make_eval_step(EvalSpec(pad=True), 17, "cpu", "f32"))
    for mode, extra in (("video_inference", {}), ("demo_video_inference", {}),
                        ("demo_video_inference", {"miccai_demo": True})):
        run = f"cli_{mode}_{len(extra)}"
        config = dict(cfg, mode=mode, run_id=run, **extra)
        (tmp_path / f"{run}.json").write_text(json.dumps(config))
        res = main(["-c", str(tmp_path / f"{run}.json"), "-dp",
                    str(tmp_path / "cadis" / "data")], device="cpu")
        side = mode == "demo_video_inference" and not extra
        assert res["codec"] == ["avi_raw"] and res["side_by_side"] == side
        assert res["frames"] == 3 + 2
        pt.config = dict(config, data_path=str(tmp_path / "cadis" / "data"))
        _, want = _captured(monkeypatch, lambda: video.demo_infer(pt, batch_size=8),
                            Capture, video_io, "open_writer")
        monkeypatch.setattr(video_io, "cv2", None)
        for out in res["outputs"]:
            r = video_io.open_reader(out)
            frames_want = want[pathlib.Path(out).name]
            assert r.frame_count == len(frames_want) and r.shape[1] == (2 * W if side else W)
            for i, f in enumerate(frames_want):
                np.testing.assert_array_equal(r.read(i), f)
