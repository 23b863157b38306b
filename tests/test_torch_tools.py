"""The port's offline data tools (tools/build_frame_table.py,
tools/add_blacklist.py, tools/class_analysis.py of the port package)
against the repository's JAX-side tools (pandas, PIL, cv2) on the same
inputs:

  * `FrameTable.to_csv` byte-equal to pandas' `to_csv(index=False)` and
    `to_string` equal to its `to_string(index=False)`;
  * the frame table built from a tiny CaDIS tree (grey and RGB labels,
    frames listed out of order) byte-equal to the JAX tool's, with and
    without the pixel counts, its printed line equal, and the same error
    on a label id above 35;
  * the blacklist join byte-equal, on data/data.csv and on a label table
    longer than the frame table, and the same refusal of a mismatched row;
  * the class distribution and split quality equal, their printed report
    equal; the permutation search at seed 0 over 300 tries drawing the same
    permutations, with split percentages and closeness within 1e-12;
  * the label overlays pixel-equal to the JAX tool's cv2 output (BGR read
    back as RGB).
"""
import pathlib
import sys

import cv2
import numpy as np
import pandas as pd
import pytest

from tools import add_blacklist as jax_add_blacklist
from tools import build_frame_table as jax_build_frame_table
from tools import class_analysis as jax_class_analysis

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (
    FrameTable, load_frame_table)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.png import read_png, write_png
from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import (
    add_blacklist, build_frame_table, class_analysis)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA_CSV = ROOT / "data" / "data.csv"
H, W = 18, 26


def write_cadis(root, frames: dict, max_id: int = 35, seed: int = 0):
    """A tiny CaDIS tree: {video: [(name, rgb_label)]}, images random RGB,
    labels random canonical ids (blocks, so overlays have edges), grey or
    RGB (channel 0 the ids, the others noise)."""
    rng = np.random.default_rng(seed)
    for vid, names in frames.items():
        for name, rgb in names:
            ids = np.repeat(np.repeat(rng.integers(0, max_id + 1, (H // 3 + 1, W // 4 + 1)),
                                      3, 0), 4, 1)[:H, :W].astype(np.uint8)
            lbl = np.stack([ids, rng.integers(0, 256, (H, W), dtype=np.uint8),
                            rng.integers(0, 256, (H, W), dtype=np.uint8)], -1) if rgb else ids
            for sub, px in (("Images", rng.integers(0, 256, (H, W, 3), dtype=np.uint8)),
                            ("Labels", lbl)):
                (root / f"Video{vid:02d}" / sub).mkdir(parents=True, exist_ok=True)
                write_png(root / f"Video{vid:02d}" / sub / name, px)
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cadis") / "data"
    (root / "notes").mkdir(parents=True)          # not a video folder
    return write_cadis(root, {
        12: [("Video12_frame000020.png", True), ("Video12_frame000010.png", False)],
        3: [("Video3_frame000100.png", False), ("Video3_frame000090.png", True),
            ("Video3_frame000110.png", False)],
        22: [("Video22_frame000000.png", True)]})


def run_main(monkeypatch, capsys, main, argv):
    """A tool's `main` run with `argv` as its command line: what it printed."""
    monkeypatch.setattr(sys, "argv", ["tool", *map(str, argv)])
    main()
    return capsys.readouterr().out


# ---------------------------------------------------------------------------
# The table's CSV writer and text form
# ---------------------------------------------------------------------------

def test_to_csv_and_to_string_equal_pandas(tmp_path):
    rng = np.random.default_rng(1)
    cols = {"a": np.array([1, -2, 30]), "s": np.array(["x,y", 'q"t', ""], dtype=object),
            "f": np.array([0.1, np.nan, 1e20]), "b": np.array([True, False, True]),
            "o": np.array(["z", None, "w\nv"], dtype=object),
            "g": np.concatenate([[1.5e-5, -0.0], rng.standard_normal(1)]),
            "Unnamed: 0": np.arange(3)}
    FrameTable(cols).to_csv(tmp_path / "port.csv")
    pd.DataFrame(cols).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()
    text = {"class": np.array(["Pupil", "Surgical Tape", "Ignore"], dtype=object),
            "frame_freq": np.array([1.0, 0.123456, 0.0]),
            "pixel_share": np.array([0.5, np.nan, 1e-7])}
    assert FrameTable(text).to_string("%.4f") == \
        pd.DataFrame(text).to_string(index=False, float_format="%.4f")
    # data.csv read and written back: what pandas reads and writes
    FrameTable.read_csv(DATA_CSV).to_csv(tmp_path / "port_data.csv")
    pd.read_csv(DATA_CSV).to_csv(tmp_path / "pandas_data.csv", index=False)
    assert (tmp_path / "port_data.csv").read_bytes() == \
        (tmp_path / "pandas_data.csv").read_bytes()


# ---------------------------------------------------------------------------
# build_frame_table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counts", [True, False])
def test_frame_table_bytes_equal_jax(tree, tmp_path, monkeypatch, capsys, counts):
    flag = [] if counts else ["--no-pixel-counts"]
    want = run_main(monkeypatch, capsys, jax_build_frame_table.main,
                    ["-p", tree, "-o", tmp_path / "jax.csv", *flag])
    got = run_main(monkeypatch, capsys, build_frame_table.main,
                   ["-p", tree, "-o", tmp_path / "port.csv", *flag])
    assert got.replace("port.csv", "jax.csv") == want
    assert want.startswith("6 frames x 3 videos -> ")
    data = (tmp_path / "port.csv").read_bytes()
    assert data == (tmp_path / "jax.csv").read_bytes()
    table = FrameTable.read_csv(tmp_path / "port.csv")
    assert table["img_path"][0] == "Video03/Images/Video3_frame000090.png"
    if counts:     # every pixel of every frame counted
        assert all(sum(table.row(i)[n] for n in table.columns[6:]) == H * W
                   for i in range(len(table)))


def test_frame_table_refuses_ids_above_35(tmp_path):
    root = write_cadis(tmp_path / "bad", {5: [("Video5_frame000000.png", False)]},
                       max_id=40, seed=3)
    with pytest.raises(ValueError) as want:
        jax_build_frame_table.build_frame_table(root)
    with pytest.raises(ValueError) as got:
        build_frame_table.build_frame_table(root)
    assert str(got.value) == str(want.value) == \
        "Video05/Labels/Video5_frame000000.png: ids outside 0..35 found"


# ---------------------------------------------------------------------------
# add_blacklist
# ---------------------------------------------------------------------------

def test_blacklist_join_bytes_equal_jax(tmp_path, monkeypatch, capsys):
    data = pd.read_csv(DATA_CSV)
    data["blacklisted"] = (np.arange(len(data)) % 7 == 3).astype(int)
    data.to_csv(tmp_path / "frames.csv", index=False)
    # the whole table (its file_name column checked row by row), then a
    # label table longer than the frame table (blanks beyond it)
    label = data.drop(columns=["blacklisted"]).assign(
        score=np.round(np.linspace(0, 1, len(data)), 6))   # what pandas reads back exactly
    label.to_csv(tmp_path / "labels.csv", index=False)
    data.iloc[:5].to_csv(tmp_path / "short.csv", index=False)
    label.iloc[:8].drop(columns=["file_name"]).to_csv(tmp_path / "long.csv", index=False)
    for frames, labels in (("frames.csv", "labels.csv"), ("short.csv", "long.csv")):
        outs = {}
        for side, main in (("jax", jax_add_blacklist.main), ("port", add_blacklist.main)):
            printed = run_main(monkeypatch, capsys, main, [
                "--label-table", tmp_path / labels, "--csv", tmp_path / frames,
                "-o", tmp_path / f"{side}.csv"])
            outs[side] = (printed.replace(f"{side}.csv", ""),
                          (tmp_path / f"{side}.csv").read_bytes())
        assert outs["port"] == outs["jax"]
    assert pd.read_csv(tmp_path / "port.csv")["blacklisted"].isna().sum() == 3


def test_blacklist_refuses_a_mismatched_row(tmp_path, monkeypatch):
    data = pd.read_csv(DATA_CSV).iloc[:6]
    data.to_csv(tmp_path / "frames.csv", index=False)
    data.iloc[[0, 1, 3, 2, 4, 5]].to_csv(tmp_path / "labels.csv", index=False)
    argv = ["--label-table", tmp_path / "labels.csv", "--csv", tmp_path / "frames.csv",
            "-o", tmp_path / "out.csv"]
    monkeypatch.setattr(sys, "argv", ["tool", *map(str, argv)])
    with pytest.raises(AssertionError, match="row 2: label-table file"):
        jax_add_blacklist.main()
    with pytest.raises(AssertionError, match="row 2: label-table file"):
        add_blacklist.main([str(a) for a in argv])


# ---------------------------------------------------------------------------
# class_analysis
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tables():
    return pd.read_csv(DATA_CSV), load_frame_table(str(DATA_CSV))


@pytest.mark.parametrize("task", [1, 2, 3])
def test_class_distribution_equals_jax(tables, task):
    want = jax_class_analysis.class_distribution(tables[0], task)
    got = class_analysis.class_distribution(tables[1], task)
    assert got.columns == list(want.columns)
    assert list(got["class"]) == list(want["class"])
    for col in ("frame_freq", "pixel_share"):
        np.testing.assert_array_equal(got[col], want[col].to_numpy())


@pytest.mark.parametrize("split", [0, 1, 2, 3])
def test_split_quality_equals_jax(tables, split):
    assert class_analysis.split_quality(tables[1], split) == \
        jax_class_analysis.split_quality(tables[0], split)


def test_report_prints_as_jax(tmp_path, monkeypatch, capsys):
    argv = ["--csv", DATA_CSV, "--split", "2"]
    want = run_main(monkeypatch, capsys, jax_class_analysis.main, argv)
    got = run_main(monkeypatch, capsys, class_analysis.main, argv)
    assert got == want
    assert "--- split 2 quality ---" in got and "test_frames: " in got


def test_split_search_draws_the_jax_permutations(tables, capsys):
    """The port's search over 300 tries at seed 0 with thresholds every
    candidate passes: the JAX tool's permutations in order, and at every
    30th the JAX tool's split percentages and closeness (its pandas
    evaluation takes 0.2 s a try); then 10 tries at the default
    thresholds, the two searches' results and printed lines equal."""
    tries, every = 300, 30
    loose = (0.0, 1.0, 1e9, 1e9)
    got = class_analysis.split_search(tables[1], tries, loose, seed=0, verbose=False)
    rng = np.random.default_rng(0)
    perms = [jax_class_analysis.permutation_candidate(rng) for _ in range(tries)]
    assert [g["permutation"] for g in got] == perms
    for g, perm in list(zip(got, perms))[::every]:
        pct, closeness, passing = jax_class_analysis.evaluate_permutation(
            tables[0], perm, loose)
        assert passing
        np.testing.assert_allclose(g["split_percentages"], pct, rtol=0, atol=1e-12)
        for t in (1, 2, 3):
            assert abs(g["mean_closeness"][t] - float(np.mean(closeness[t]))) <= 1e-12
    want = jax_class_analysis.split_search(tables[0], 10, seed=0)
    want_out = capsys.readouterr().out
    assert class_analysis.split_search(tables[1], 10, seed=0) == want
    assert capsys.readouterr().out == want_out


@pytest.mark.parametrize("task,limit", [(0, None), (1, None), (2, 4), (3, None)])
def test_overlays_pixel_equal_jax(tree, tmp_path, task, limit):
    built = build_frame_table.build_frame_table(tree)
    built.to_csv(tmp_path / "table.csv")
    want = jax_class_analysis.check_labels(pd.read_csv(tmp_path / "table.csv"), str(tree),
                                           task, str(tmp_path / "jax"), limit)
    got = class_analysis.check_labels(built, str(tree), task, str(tmp_path / "port"), limit)
    assert got == want and len(got) == (limit or 6)
    for name in got:
        bgr = cv2.imread(str(tmp_path / "jax" / name))
        rgb = read_png(tmp_path / "port" / name, 3)
        np.testing.assert_array_equal(rgb, bgr[..., ::-1])


def test_overlays_skip_missing_frames(tree, tmp_path):
    table = build_frame_table.build_frame_table(tree, count_pixels=False)
    moved = table.set_column("img_path", np.asarray(
        ["missing.png"] + list(table["img_path"][1:]), dtype=object))
    got = class_analysis.check_labels(moved, str(tree), 2, str(tmp_path / "out"))
    assert len(got) == 5
