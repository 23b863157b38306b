"""The port's host transforms (data/transforms.py) and their batch path
against the JAX package and cv2, from seeded numpy inputs and generators.

Bit-equal for equal generators: `largest_valid_rect`, `CropTransform`
(random and class-frequency modes, the JAX package's window kept),
`AffineTransform` (the port's numpy warp against the JAX package's
cv2.warpPerspective, the image bilinear and the label nearest, at 540x960
and at widths that are not a multiple of 16; with `crop_to_fit`, its
cv2.resize too), the warp and the resize against cv2 itself (uint8 and
float32 sources, twice-size outputs, up- and downscales),
`build_transform_pipeline` for every transform name, and the batches of
`assemble_batch`/`epoch_iterator` with host transforms. A Trainer run
interrupted after epoch 0 and resumed from `last` ends bit-equal to the
uninterrupted run with the affine and crop transforms on.
"""
import cv2
import numpy as np
import pytest
import torch

from miccai2021_cataract_semantic_segmentation_tpu.data import ArrayDataset as JaxArrayDataset
from miccai2021_cataract_semantic_segmentation_tpu.data import pipeline as jax_pipeline
from miccai2021_cataract_semantic_segmentation_tpu.data import transforms as jtf

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import pipeline
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import transforms as tf
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import FrameTable
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import ArrayDataset
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import trainer as trainer_module
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's tests and fixtures: the suite
    runs in several processes at once, and torch's thread pools in each
    would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed, h, w, n_values=18):
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, n_values, (h // 8 + 1, w // 8 + 1))
    lbl = np.repeat(np.repeat(grid, 8, 0), 8, 1)[:h, :w].astype(np.uint8)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    return img, lbl


def _affine(**kw):
    opts = dict(rotation=15.0, rot_centre_offset=(0.1, 0.1), shift=0.1,
                shear=(0.1, 0.1), shear_centre_offset=(0.2, 0.2))
    opts.update(kw)
    return jtf.AffineTransform(**opts), tf.AffineTransform(**opts)


@pytest.mark.parametrize("hw", [(540, 960), (61, 87), (45, 122)])
@pytest.mark.parametrize("seed", [0, 1])
def test_affine_transform_bit_equal_to_jax(hw, seed):
    img, lbl = _frame(seed, *hw)
    jt, pt = _affine()
    rng_j, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
    want, got = jt(img, lbl, rng_j), pt(img, lbl, rng_p)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert rng_p.random() == rng_j.random()          # the same draws, in order
    assert (got[1] == 0).any() and got[0].dtype == np.uint8


@pytest.mark.parametrize("hw", [(180, 320), (77, 101)])
def test_affine_crop_to_fit_bit_equal_to_jax(hw):
    img, lbl = _frame(4, *hw)
    jt, pt = _affine(crop_to_fit=True)
    want = jt(img, lbl, np.random.default_rng(2))
    got = pt(img, lbl, np.random.default_rng(2))
    assert got[0].shape == want[0].shape == img.shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("src_kind", ["rgb", "label", "mask"])
@pytest.mark.parametrize("scale", [1, 2])
def test_warp_perspective_equals_cv2(src_kind, scale):
    img, lbl = _frame(7, 75, 133)
    src = {"rgb": img, "label": lbl, "mask": np.ones(lbl.shape, np.float32)}[src_kind]
    out = (133 * scale, 75 * scale)
    for seed in range(3):
        m = tf.AffineTransform(rotation=20, shift=0.2).matrix(75, 133,
                                                              np.random.default_rng(seed))
        flags = cv2.INTER_NEAREST if src_kind == "label" else cv2.INTER_LINEAR
        want = cv2.warpPerspective(src, m, out, flags=flags)
        got = tf.warp_perspective(src, m, out, nearest=src_kind == "label")
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_resize_equals_cv2():
    rng = np.random.default_rng(0)
    for (sh, sw), (oh, ow) in (((117, 203), (540, 960)), ((300, 481), (540, 960)),
                               ((540, 960), (540, 960)), ((540, 960), (211, 333)),
                               ((31, 45), (64, 17))):
        src = rng.integers(0, 256, (sh, sw, 3), dtype=np.uint8)
        np.testing.assert_array_equal(tf.resize(src, (ow, oh)), cv2.resize(src, (ow, oh)))
        np.testing.assert_array_equal(
            tf.resize(src[..., 0], (ow, oh), nearest=True),
            cv2.resize(src[..., 0], (ow, oh), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("aspect", [(540, 960), (1, 1), (3, 2)])
@pytest.mark.parametrize("scale", [16, 8])
def test_largest_valid_rect_bit_equal_to_jax(aspect, scale):
    for seed in range(4):
        m = tf.AffineTransform(rotation=25, shift=0.2).matrix(270, 480,
                                                              np.random.default_rng(seed))
        valid = cv2.warpPerspective(np.ones((270, 480), np.float32), m, (960, 540))
        assert tf.largest_valid_rect(valid, aspect, scale) == \
            jtf.largest_valid_rect(valid, aspect, scale)
    empty = np.zeros((64, 64), np.float32)
    assert tf.largest_valid_rect(empty, aspect, scale) == \
        jtf.largest_valid_rect(empty, aspect, scale)


@pytest.mark.parametrize("mode", ["random", "freq"])
@pytest.mark.parametrize("task,size,hw", [(1, 0.4, (540, 960)), (2, 0.4, (540, 960)),
                                          (3, 0.7, (100, 150)), (2, 1.0, (96, 64))])
def test_crop_transform_bit_equal_to_jax(mode, task, size, hw):
    """Both modes for equal generators, the `freq` window bounded by the
    frame's height as the JAX package bounds it (also where it is wider
    than tall)."""
    img, lbl = _frame(task, *hw, n_values=taxonomy.num_label_values(task))
    jt = jtf.CropTransform(size=size, mode=mode, task=task)
    pt = tf.CropTransform(size=size, mode=mode, task=task)
    np.testing.assert_array_equal(pt.class_frequencies, jt.class_frequencies)
    for seed in range(3):
        rng_j, rng_p = np.random.default_rng(seed), np.random.default_rng(seed)
        want, got = jt(img, lbl, rng_j), pt(img, lbl, rng_p)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[0].flags["C_CONTIGUOUS"] and rng_p.random() == rng_j.random()
    assert got[1].shape[0] % 32 == 0 or got[1].shape[0] == min(hw)
    with pytest.raises(ValueError, match="not recognised"):
        tf.CropTransform(mode="grid")(img, lbl, np.random.default_rng(0))


TRANSFORM_LISTS = [["rot"], ["shift"], ["shear"], ["affine"], ["crop"],
                   ["rot", "shift", "shear"], ["pad", "affine", "flip", "colorjitter"],
                   ["pad", "crop", "flip", "torchvision_normalise"],
                   ["crop", "flip", "colorjitter", "torchvision_normalise"],
                   ["rot", "crop", "blur", "pseudo_colorjitter", {"strength": 4}]]


@pytest.mark.parametrize("transforms", TRANSFORM_LISTS)
@pytest.mark.parametrize("values", [{}, {"crop_size": 0.6, "crop_mode": "freq"}])
def test_build_transform_pipeline_equals_jax(transforms, values):
    want = jtf.build_transform_pipeline(transforms, values, 2)
    got = tf.build_transform_pipeline(transforms, values, 2)
    assert [type(t).__name__ for t in got.host_train] == \
        [type(t).__name__ for t in want.host_train]
    for g, w in zip(got.host_train, want.host_train):
        gv, wv = dict(vars(g)), dict(vars(w))
        if "class_frequencies" in gv:
            np.testing.assert_array_equal(gv.pop("class_frequencies"),
                                          wv.pop("class_frequencies"))
        assert gv == wv
    assert vars(got.device) == vars(want.device)
    assert got.valid_pad == want.valid_pad
    assert got.device.pad == ("pad" in transforms and "crop" not in transforms)


def _sets(n=6, h=64, w=96):
    frames = [_frame(10 + i, h, w) for i in range(n)]
    images = np.stack([f[0] for f in frames])
    labels = np.stack([f[1] for f in frames])
    return images, labels


@pytest.mark.parametrize("seeded", [True, False])
def test_assemble_batch_with_host_transforms_equals_jax(seeded):
    images, labels = _sets()
    transforms = ["affine", "crop", "flip"]
    values = {"crop_size": 0.5}
    jp = jtf.build_transform_pipeline(transforms, values, 2)
    pp = tf.build_transform_pipeline(transforms, values, 2)
    rng_j = np.random.default_rng(5) if seeded else None
    rng_p = np.random.default_rng(5) if seeded else None
    for idx in (np.array([0, 3, 5]), np.array([1, 1, 4])):
        want = jax_pipeline.assemble_batch(JaxArrayDataset(images, labels), idx, jp, rng_j)
        got = pipeline.assemble_batch(ArrayDataset(images, labels), idx, pp, rng_p)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
        assert got[0].shape == (3, 32, 32, 3)        # crop 0.5 of 64 rows


def test_epoch_iterator_draws_from_the_epoch_seed():
    """The port's epoch_iterator and the JAX package's give the same
    batches for the same seed; the host transforms skip a dataset's native
    batch decode."""
    images, labels = _sets()
    pp = tf.build_transform_pipeline(["affine", "crop"], {}, 2)
    jp = jtf.build_transform_pipeline(["affine", "crop"], {}, 2)
    batches = np.array([[0, 1], [2, 3], [4, 5]])

    class Native(ArrayDataset):
        def load_batch(self, indices):
            raise AssertionError("a native batch decode with a host transform active")

    got = list(pipeline.epoch_iterator(Native(images, labels), batches, "cpu",
                                       prefetch=2, pipeline=pp, seed=9))
    want = list(jax_pipeline.epoch_iterator(JaxArrayDataset(images, labels), batches,
                                            jp, seed=9, prefetch=0))
    assert len(got) == len(want) == 3
    for (gi, gl, _), (wi, wl, _) in zip(got, want):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    plain = list(pipeline.epoch_iterator(ArrayDataset(images, labels), batches, "cpu",
                                         prefetch=0))
    assert plain[0][0].shape == (2, 64, 96, 3)


class _Writer:
    """A stand-in for TBLogger (tensorboard's import is slow here)."""

    def __init__(self, log_dir):
        pass

    def __getattr__(self, name):
        return lambda *a, **k: None


def _trainer_config(tmp_path, run_id):
    return {"name": "host", "mode": "training", "run_id": run_id, "seed": 4,
            "log_path": str(tmp_path), "precision": "f32", "valid_batch_size": 2,
            "log_every_n_epochs": 1, "max_valid_imgs": 0,
            "graph": {"model": "EncDec", "encoder": {"model": "ResNet18"},
                      "decoder": {"model": "UPerNet", "ppm_num_ch": 16, "fpn_num_ch": 16}},
            "loss": {"name": "LovaszSoftmax", "lovasz_impl": "bucket"},
            "data": {"experiment": 2, "batch_size": 2, "split": 0,
                     "transforms": ["affine", "crop", "flip", "pad"],
                     "transform_values": {"crop_size": 0.5}},
            "train": {"epochs": 2, "learning_rate": 1e-3}}


def test_trainer_resume_with_host_transforms_bit_equal(tmp_path, monkeypatch):
    monkeypatch.setattr(trainer_module, "TBLogger", _Writer)
    images, labels = _sets(n=4)
    n = len(images)
    cols = {"vid_num": np.ones(n, int), "blacklisted": np.zeros(n, int)}
    df = FrameTable(cols)
    sets = (ArrayDataset(images, labels), ArrayDataset(images[:2], labels[:2]), df, df)
    seen = []
    step = trainer_module.make_train_step

    def recording(*a, **k):
        inner = step(*a, **k)

        def run(state, images_u8, labels_u8, epoch, draws=None):
            seen.append(tuple(images_u8.shape))
            return inner(state, images_u8, labels_u8, epoch, draws)
        return run

    monkeypatch.setattr(trainer_module, "make_train_step", recording)
    full = Trainer(_trainer_config(tmp_path, "full"), sets, device="cpu")
    assert not full.pipeline.device.pad and full.pipeline.valid_pad
    full.train()
    assert set(seen) == {(2, 32, 32, 3)}            # the crops reach the step
    stopped = Trainer(_trainer_config(tmp_path, "resumed"), sets, device="cpu")
    stopped.epochs = 1                              # the run stops after epoch 0
    stopped.train()
    resumed = Trainer(_trainer_config(tmp_path, "resumed"), sets, device="cpu")
    resumed.load_checkpoint("last")
    assert resumed.start_epoch == 1
    resumed.train()
    for (k, a), b in zip(full.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    np.testing.assert_array_equal(resumed.ind_counts, full.ind_counts)
    for e in range(2):
        np.testing.assert_array_equal(resumed.epoch_batches[e], full.epoch_batches[e])
