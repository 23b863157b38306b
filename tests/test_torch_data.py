"""The port's host data path against the JAX package's (pandas and cv2 there,
numpy and the standard library in the port): the frame table and its
splits on data/data.csv, the label remaps, the metrics the Trainer reads,
the PNG decoder against cv2 (files written by cv2, PIL and the port's own
encoder with each filter type), SegDataset and assemble_batch (native and
per-sample decode) on a synthetic tree, the transform pipeline, and
epoch_iterator's batches and error path. Every comparison is exact."""
import pathlib
import struct
import threading
import zlib

import cv2
import numpy as np
import pandas as pd
import pytest
import torch
from PIL import Image

from miccai2021_cataract_semantic_segmentation_tpu import taxonomy as jax_taxonomy
from miccai2021_cataract_semantic_segmentation_tpu.data import dataframe as jdf
from miccai2021_cataract_semantic_segmentation_tpu.data import dataset as jds
from miccai2021_cataract_semantic_segmentation_tpu.data import pipeline as jpipe
from miccai2021_cataract_semantic_segmentation_tpu.data import transforms as jtf
from miccai2021_cataract_semantic_segmentation_tpu.ops import metrics as jmetrics
from miccai2021_cataract_semantic_segmentation_tpu.ops import remap as jremap

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import (
    DECODED, ArrayDataset, SegDataset, assemble_batch, build_transform_pipeline,
    dataframe, epoch_iterator, pad_or_trim_batches, png, reset_decoded)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import dataset as pds
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops import metrics, remap
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
    COLUMNS, canonical_from_network, write_tree)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSV = ROOT / "data" / "data.csv"


@pytest.fixture(scope="module")
def tables():
    return dataframe.load_frame_table(str(CSV)), jdf.load_frame_table(str(CSV))


def _same_table(port, ref):
    assert list(port["img_path"]) == ref["img_path"].tolist()
    assert list(port["lbl_path"]) == ref["lbl_path"].tolist()
    for col in ("index", "Unnamed: 0", "blacklisted", "vid_num", "per_video_index"):
        np.testing.assert_array_equal(port[col], ref[col].to_numpy())
    np.testing.assert_array_equal(dataframe.canonical_count_matrix(port),
                                  jdf.canonical_count_matrix(ref))
    for task in (1, 2, 3):
        np.testing.assert_array_equal(dataframe.task_count_matrix(port, task),
                                      jdf.task_count_matrix(ref, task))


def test_frame_table_reads_as_pandas(tables):
    port, ref = tables
    assert port.columns == list(ref.columns)
    assert len(port) == len(ref) == 4670
    for col in ref.columns:
        want = ref[col].to_numpy()
        if want.dtype.kind in "if":
            assert port[col].dtype == want.dtype, col
            np.testing.assert_array_equal(port[col], want)
        else:
            assert [None if v is None else str(v) for v in port[col]] == \
                [None if isinstance(v, float) else v for v in want], col
    assert COLUMNS == tuple("" if c == "Unnamed: 0" else c for c in ref.columns)


@pytest.mark.parametrize("blacklist", [True, False])
@pytest.mark.parametrize("use_relabeled", [False, True])
@pytest.mark.parametrize("mode", ["training", "inference"])
@pytest.mark.parametrize("split", range(len(taxonomy.DATA_SPLITS)))
def test_split_equals_pandas(tables, split, mode, use_relabeled, blacklist):
    port, ref = tables
    got = dataframe.split_dataframes(port, split, mode, use_relabeled, blacklist)
    want = jdf.split_dataframes(ref, split, mode, use_relabeled, blacklist)
    for g, w in zip(got, want):
        _same_table(g, w)


@pytest.mark.parametrize("fracs,seed", [((0.7, 0.2), 0), ((0.8, 0.1), 3),
                                        ((0.5, 0.25), 11)])
def test_random_split_equals_pandas_sample(tables, fracs, seed):
    port, ref = tables
    got = dataframe.split_dataframes(port, 1, random_split=list(fracs), seed=seed)
    want = jdf.split_dataframes(ref, 1, random_split=list(fracs), seed=seed)
    for g, w in zip(got, want):
        _same_table(g, w)


@pytest.mark.parametrize("task", sorted(taxonomy.TASK_GROUPS))
def test_remaps_equal_jax_on_every_byte(task):
    assert taxonomy.TASK_GROUPS == jax_taxonomy.TASK_GROUPS
    every = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for to_network in (True, False):
        np.testing.assert_array_equal(remap.remap_mask_np(every, task, to_network),
                                      jremap.remap_mask_np(every, task, to_network))
    np.testing.assert_array_equal(remap.mask_from_network(every, task),
                                  jremap.mask_from_network(every, task))
    np.testing.assert_array_equal(remap.mask_to_colormap(every, task),
                                  jremap.mask_to_colormap(every, task))


@pytest.mark.parametrize("task", [1, 2, 3])
def test_host_metrics_equal_jax(task):
    c = taxonomy.TASK_NUM_CLASSES[task]
    cm = np.random.default_rng(task).integers(0, 1000, (c, c)).astype(np.int64)
    cm[1] = 0
    cm[:, 2] = 0
    for mode in ("row", "col"):
        np.testing.assert_array_equal(metrics.normalise_confusion_matrix(cm, mode),
                                      jmetrics.normalise_confusion_matrix(cm, mode))
    assert metrics.mean_iou(cm, task) == jmetrics.mean_iou(cm, task)
    assert metrics.mean_iou(cm, task, (0, 3)) == jmetrics.mean_iou(cm, task, (0, 3))
    for k in (0, 1, 2, c - 1, taxonomy.IGNORE_VALUE):
        assert metrics.single_class_iou(cm, task, k) == \
            jmetrics.single_class_iou(cm, task, k)
    with pytest.raises(ValueError):
        metrics.normalise_confusion_matrix(cm, "diag")


def _frame(seed, h=45, w=77):
    """A smooth-ish RGB frame (so every filter type wins somewhere) and a
    blocky gray label."""
    rng = np.random.default_rng(seed)
    img = np.clip(rng.integers(0, 256, (1, 1, 3)) + np.cumsum(
        rng.integers(-4, 5, (h, w, 3)), axis=1), 0, 255).astype(np.uint8)
    lbl = np.repeat(rng.integers(0, 36, (h, w // 7 + 1)), 7, axis=1)[:, :w].astype(np.uint8)
    return img, lbl


@pytest.mark.parametrize("level", [0, 1, 6, 9])
@pytest.mark.parametrize("writer", ["cv2", "PIL"])
def test_decoder_bit_equal_to_cv2(tmp_path, writer, level):
    img, lbl = _frame(level)
    ip, lp = tmp_path / "i.png", tmp_path / "l.png"
    if writer == "cv2":
        cv2.imwrite(str(ip), img[..., ::-1], [cv2.IMWRITE_PNG_COMPRESSION, level])
        cv2.imwrite(str(lp), lbl, [cv2.IMWRITE_PNG_COMPRESSION, level])
    else:
        Image.fromarray(img).save(ip, compress_level=level)
        Image.fromarray(lbl).save(lp, compress_level=level)
    np.testing.assert_array_equal(png.read_png(ip), cv2.imread(str(ip))[..., ::-1])
    np.testing.assert_array_equal(png.read_png(lp, 1),
                                  cv2.imread(str(lp), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(png.read_png(lp, 3), cv2.imread(str(lp))[..., ::-1])
    np.testing.assert_array_equal(png.read_png(ip, 1),
                                  cv2.imread(str(ip), cv2.IMREAD_GRAYSCALE))
    assert png.png_dimensions(ip) == img.shape[:2]


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
def test_encoder_filters_decode_as_cv2_does(tmp_path, filt):
    img, lbl = _frame(7)
    types = np.arange(img.shape[0]) % 5 if filt == "mixed" else filt
    for pixels, flag, ch in ((img, cv2.IMREAD_COLOR, 3), (lbl, cv2.IMREAD_GRAYSCALE, 1)):
        p = tmp_path / f"{ch}.png"
        png.write_png(p, pixels, types, level=3)
        ref = cv2.imread(str(p), flag)
        np.testing.assert_array_equal(ref[..., ::-1] if ch == 3 else ref, pixels)
        np.testing.assert_array_equal(png.read_png(p, ch), pixels)
        rows = png.filter_rows(pixels, types)
        assert set(np.unique(rows[:, 0])) == set(np.unique(types))
        np.testing.assert_array_equal(png.unfilter_plain(rows, ch),
                                      pixels.reshape(rows.shape[0], -1))
        np.testing.assert_array_equal(png.unfilter_native(rows, ch),
                                      pixels.reshape(rows.shape[0], -1))


def test_read_png_raises_where_the_unfilter_does_not_build(tmp_path, monkeypatch):
    """No silent numpy stand-in: a C++ unfilter that does not build makes
    every read raise, and the failed build is not retried."""
    img, _ = _frame(1)
    path = tmp_path / "x.png"
    png.write_png(path, img, 4)
    monkeypatch.setattr(png, "_UNFILTER_FLAGS", ("-fPIC", "--no-such-flag"))
    builds = []
    compile_ = build._compile
    monkeypatch.setattr(build, "_compile", lambda jobs: builds.append(1) or compile_(jobs))
    for _ in range(2):
        with pytest.raises(RuntimeError, match="png_unfilter"):
            png.read_png(path)
    assert builds == [1]


def test_unfilters_at_frame_size():
    """Both unfilters at a CaDIS frame's size, every row type."""
    img, _ = _frame(3, 540, 960)
    rows = png.filter_rows(img, np.arange(540) % 5)
    want = img.reshape(540, -1)
    np.testing.assert_array_equal(png.unfilter_native(rows, 3), want)
    np.testing.assert_array_equal(png.unfilter_plain(rows, 3), want)


def _raw_png(path, w, h, depth, color, interlace=0, body=b"", crc_ok=True):
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)

    def chunk(kind, data, ok=True):
        return struct.pack(">I", len(data)) + kind + data + \
            struct.pack(">I", zlib.crc32(kind + data) ^ (0 if ok else 1))
    path.write_bytes(png.SIGNATURE + chunk(b"IHDR", ihdr, crc_ok)
                     + chunk(b"IDAT", zlib.compress(body)) + chunk(b"IEND", b""))


def test_unsupported_pngs_raise_with_the_path(tmp_path):
    rgb = np.zeros((4, 6, 3), np.uint8)
    Image.fromarray(rgb).convert("P").save(tmp_path / "palette.png")
    Image.fromarray(np.zeros((4, 6), np.uint16) + 300).save(tmp_path / "gray16.png")
    cases = {"palette.png": "colour type 3", "gray16.png": "bit depth 16"}
    _raw_png(tmp_path / "interlaced.png", 6, 4, 8, 2, interlace=1,
             body=bytes(4 * 19))
    cases["interlaced.png"] = "interlace 1"
    _raw_png(tmp_path / "crc.png", 6, 4, 8, 0, body=bytes(4 * 7), crc_ok=False)
    cases["crc.png"] = "corrupt"
    _raw_png(tmp_path / "short.png", 6, 4, 8, 0, body=bytes(3 * 7))
    cases["short.png"] = "bytes of image data"
    _raw_png(tmp_path / "filter9.png", 6, 4, 8, 0, body=bytes([9] + [0] * 6) * 4)
    cases["filter9.png"] = "filter type 9"
    (tmp_path / "text.png").write_bytes(b"not a png at all")
    cases["text.png"] = "not a PNG"
    for name, what in cases.items():
        with pytest.raises(ValueError, match=what) as err:
            png.read_png(tmp_path / name)
        assert name in str(err.value)
    with pytest.raises(ValueError, match="filter types"):
        png.write_png(tmp_path / "x.png", rgb, 5)


def test_native_decoder_equals_the_png_decoder(tmp_path):
    """The port's build of native/cadis_io.cpp decodes as data/png.py does
    (the CPU tests run where g++ and libpng's headers are installed)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data import native_io
    assert native_io.available(), native_io.build_error()
    img, lbl = _frame(4)
    for filt in (0, 4, np.arange(img.shape[0]) % 5):
        png.write_png(tmp_path / "i.png", img, filt)
        png.write_png(tmp_path / "l.png", lbl, filt)
        np.testing.assert_array_equal(native_io.decode_png(tmp_path / "i.png", 3), img)
        np.testing.assert_array_equal(native_io.decode_png(tmp_path / "l.png", 1), lbl)
    with pytest.raises(IOError, match="items \\[1\\]"):
        native_io.load_batch([tmp_path / "i.png"] * 2, [tmp_path / "l.png", tmp_path / "x.png"],
                             *img.shape[:2])


def test_relabelled_pngs_decode_as_cv2_does():
    for p in sorted((ROOT / "relabelled").iterdir()):
        np.testing.assert_array_equal(png.read_png(p, 1),
                                      cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))
        np.testing.assert_array_equal(png.read_png(p, 3), cv2.imread(str(p))[..., ::-1])


N_TREE, H, W = 9, 36, 52
VIDEOS = [2, 12, 22, 2, 1, 5, 12, 22, 3]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cadis")
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (N_TREE, H, W, 3), dtype=np.uint8)
    net = rng.integers(0, 18, (N_TREE, H, W), dtype=np.uint8)
    write_tree(root, images, canonical_from_network(net, 2), VIDEOS)
    return root, images, net


def test_synthetic_tree_round_trip(tree):
    root, images, net = tree
    port = dataframe.load_frame_table(data_path=str(root))
    ref = pd.read_csv(root / "data.csv")
    assert port.columns == list(ref.columns) == list(jdf.load_frame_table(
        data_path=str(root)).columns)
    for split in (1, 2):
        got = dataframe.split_dataframes(port, split, "inference", blacklist=True)
        want = jdf.split_dataframes(ref, split, "inference", blacklist=True)
        for g, w in zip(got, want):
            _same_table(g, w)
    np.testing.assert_array_equal(remap.remap_mask_np(
        canonical_from_network(net, 2), 2), net)


def _datasets(tree, task):
    root, _, _ = tree
    port_df = dataframe.split_dataframes(
        dataframe.load_frame_table(data_path=str(root)), 2, "inference")[1]
    ref_df = jdf.split_dataframes(jdf.load_frame_table(data_path=str(root)), 2,
                                  "inference")[1]
    return (SegDataset(port_df, task, str(root)),
            jds.SegDataset(ref_df, task, str(root)))


@pytest.mark.parametrize("task", [1, 2, 3])
def test_seg_dataset_and_batches_equal_jax(tree, task, monkeypatch):
    port, ref = _datasets(tree, task)
    assert len(port) == len(ref) == sum(v in (2, 12, 22) for v in VIDEOS)
    for i in range(len(port)):
        gi, gl, gm = port[i]
        wi, wl, wm = ref[i]
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
        assert gm == wm
    idx = np.array([4, 0, 2])
    want = jpipe.assemble_batch(ref, idx)
    reset_decoded()
    native = assemble_batch(port, idx)
    monkeypatch.setattr(pds.native_io, "available", lambda: False)
    per_sample = assemble_batch(port, idx)
    assert DECODED == {"native": 1, "png": 1}
    for got in (native, per_sample):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_relabeled_fallback_equals_jax(tmp_path, monkeypatch):
    """A `relabeled/<name>` label missing from the tree is read from the
    repo's relabelled/ directory, by both decoders."""
    name = "Video12_frame017650.png"           # an RGBA file
    img, _ = _frame(1, 540, 960)
    (tmp_path / "Video12" / "Images").mkdir(parents=True)
    png.write_png(tmp_path / "Video12" / "Images" / name, img, 4)
    rows = {"img_path": [f"Video12/Images/{name}"], "lbl_path": [f"relabeled/{name}"],
            "vid_num": [12]}
    port = SegDataset(dataframe.FrameTable({k: np.asarray(v, dtype=object if k != "vid_num"
                                                          else np.int64)
                                            for k, v in rows.items()}),
                      2, str(tmp_path))
    ref = jds.SegDataset(pd.DataFrame(rows), 2, str(tmp_path))
    want = ref[0]
    for g, w in zip(port[0][:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    native = assemble_batch(port, [0])
    monkeypatch.setattr(pds.native_io, "available", lambda: False)
    per_sample = assemble_batch(port, [0])
    for got in (native, per_sample):
        np.testing.assert_array_equal(got[0][0], want[0])
        np.testing.assert_array_equal(got[1][0], want[1])


@pytest.mark.parametrize("transforms", [["pad"], [], ["pad", "flip", "blur", "colorjitter"],
                                        ["flip", "torchvision_normalise"],
                                        ["pad", "pseudo_colorjitter", {"strength": 3}]])
def test_transform_pipeline_equals_jax(transforms):
    got = build_transform_pipeline(transforms, {}, 2)
    want = jtf.build_transform_pipeline(transforms, {}, 2)
    assert got.valid_pad == want.valid_pad and want.host_train == []
    assert vars(got.device) == vars(want.device)


def test_host_transforms_still_raise():
    for name in ("rot", "crop"):
        with pytest.raises(NotImplementedError, match="item 7"):
            build_transform_pipeline(["pad", name], {}, 2)


@pytest.mark.parametrize("steps", [None, 2, 6, 11])
def test_pad_or_trim_equals_jax(steps):
    b = np.arange(8).reshape(4, 2)
    np.testing.assert_array_equal(pad_or_trim_batches(b, steps),
                                  jpipe.pad_or_trim_batches(b, steps))


@pytest.mark.parametrize("prefetch", [2, 0, 1])
def test_epoch_iterator_yields_the_jax_batches(tree, prefetch):
    port, ref = _datasets(tree, 2)
    batches = pad_or_trim_batches(np.array([[0, 1], [2, 3], [4, 0]]), 5)
    want = list(jpipe.epoch_iterator(ref, batches, prefetch=2))
    got = list(epoch_iterator(port, batches, "cpu", prefetch=prefetch))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g[0].dtype == torch.uint8 and g[1].dtype == torch.uint8
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


class _Failing(ArrayDataset):
    def __getitem__(self, idx):
        if idx == 5:
            raise OSError("frame 5 is unreadable")
        return super().__getitem__(idx)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_worker_error_reaches_the_consumer(prefetch):
    rng = np.random.default_rng(0)
    ds = _Failing(rng.integers(0, 256, (8, 4, 6, 3), dtype=np.uint8),
                  rng.integers(0, 18, (8, 4, 6), dtype=np.uint8))
    before = set(threading.enumerate())
    seen = []
    with pytest.raises(OSError, match="frame 5"):
        for imgs, _, idx in epoch_iterator(ds, np.arange(8).reshape(4, 2), "cpu",
                                           prefetch=prefetch):
            seen.append(idx.tolist())
    assert seen == [[0, 1], [2, 3]]
    for t in set(threading.enumerate()) - before:
        t.join(timeout=10)
        assert not t.is_alive()


def test_epoch_iterator_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    ds = ArrayDataset(np.zeros((2, 4, 4, 3), np.uint8), np.zeros((2, 4, 4), np.uint8))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(epoch_iterator(ds, np.arange(2).reshape(1, 2)))
