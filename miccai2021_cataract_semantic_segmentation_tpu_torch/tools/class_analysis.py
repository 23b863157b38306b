"""Offline class-distribution and split-quality analysis on the frame table
(the port's counterpart of the repository's tools/class_analysis.py, the
reference's utils/data_class_analysis.py, without pandas or cv2):

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.class_analysis \
        --csv data/data.csv [--split 2] [--search-splits TRIES [--seed S]] \
        [--check-labels DATA_PATH [--task T] [--limit N]]

It prints each task's class distribution and a split's quality, runs the
5-fold video-permutation search (the same permutations as the JAX tool's
for a seed), or writes label/image overlays for inspection (the JAX tool's
pixels, as RGB PNGs).
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (
    FrameTable, load_frame_table, task_count_matrix)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.png import read_png, write_png
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.remap import (
    mask_to_colormap, remap_mask_np)


def _videos(df: FrameTable, vids) -> FrameTable:
    return df.select(np.isin(df["vid_num"], list(vids)))


def class_distribution(df: FrameTable, task: int) -> FrameTable:
    """Per task class: frame presence frequency + pixel share."""
    counts = task_count_matrix(df, task)
    presence = (counts > 0).mean(axis=0)
    pixel_share = counts.sum(axis=0) / counts.sum()
    base = list(taxonomy.TASK_CLASS_NAMES[task])
    names = (base + ["Ignore"] * (counts.shape[1] - len(base)))[: counts.shape[1]]
    return FrameTable({"class": np.asarray(names, dtype=object),
                       "frame_freq": presence, "pixel_share": pixel_share})


def split_quality(df: FrameTable, split: int) -> dict:
    """Per-subset class coverage: a good split has every class present in
    every subset (reference data_class_analysis.py:277-318)."""
    spl = taxonomy.DATA_SPLITS[int(split)]
    names = ["train", "valid", "test"][: len(spl)]
    report = {}
    for name, vids in zip(names, spl):
        part = _videos(df, vids)
        for task in (1, 2, 3):
            counts = task_count_matrix(part, task)
            n_real = taxonomy.TASK_NUM_CLASSES[task]
            missing = [taxonomy.TASK_CLASS_NAMES[task][i]
                       for i in range(n_real) if counts[:, i].sum() == 0]
            report[f"{name}_t{task}_missing"] = missing
        report[f"{name}_frames"] = len(part)
    return report


# ---------------------------------------------------------------------------
# 5-fold video-permutation split search (data_class_analysis.py:175-366)
# ---------------------------------------------------------------------------

# Videos containing the rarest classes at pixel share > 1e-4, observed on
# the CaDIS label tables (reference data_class_analysis.py:194-210,
# `video_nums_strict`). Keys are (task, network class id).
RARE_CLASS_VIDEOS = {
    (0, 0): list(range(25)),                 # all videos (fill the rest)
    (2, 17): [7, 9, 13, 18, 23, 24],
    (2, 16): [4, 7, 9, 10, 11, 13, 15, 18, 20, 23, 24],
    (3, 25): [0, 7, 9, 11, 13, 18, 23, 24],
    (3, 24): [0, 11, 15],
    (3, 22): [0, 1, 2, 4, 11, 20, 24],
    (3, 21): [0, 1, 2, 6, 9, 12, 14, 16, 18, 20],
    (3, 18): [0, 1, 2, 6, 11, 12, 13, 14, 15, 17, 20, 21, 23],
    (3, 20): [0, 1, 3, 4, 15, 17, 20, 21, 23],
}
# constraint priority (reference :213-221; commented-out keys kept disabled)
PRIORITY_KEYS = [(3, 25), (2, 17), (3, 24), (2, 16), (0, 0)]
# classes for which the closeness constraints are unsatisfiable on CaDIS
# (reference :291-296)
IMPOSSIBLE_CLASSES = {1: [], 2: [17], 3: [24, 25]}


def permutation_candidate(rng: np.random.Generator) -> list[int]:
    """One random 25-video permutation: allocate rare-class videos evenly
    over the 5 folds first, then fill (data_class_analysis.py:175-240). The
    draws are the JAX tool's, in its order."""
    keys = list(PRIORITY_KEYS)
    rng.shuffle(keys)
    folds: list[list[int]] = [[], [], [], [], []]
    for key in keys:
        vid_list = np.array(RARE_CLASS_VIDEOS[tuple(key)])
        allocated = [v for fold in folds for v in fold]
        todo = np.setdiff1d(vid_list, allocated)
        rng.shuffle(todo)
        for vid in todo:
            fill = [len(set(f) & set(vid_list.tolist())) for f in folds]
            folds[int(np.argmin(fill))].append(int(vid))
    perm = [v for fold in folds for v in fold]
    assert np.unique(perm).size == 25, "permutation not valid"
    return perm


def video_counts(df: FrameTable) -> dict:
    """Each video's frame count and, per task, its summed class pixel
    counts: what a fold's distribution sums (integers, exact in float64,
    so summing videos gives the sum over frames)."""
    vids, inverse = np.unique(df["vid_num"], return_inverse=True)
    sums = {}
    for task in (1, 2, 3):
        sums[task] = np.zeros((len(vids), taxonomy.num_label_values(task)))
        np.add.at(sums[task], inverse, task_count_matrix(df, task))
    return {"vids": vids, "frames": np.bincount(inverse, minlength=len(vids)),
            "sums": sums}


def _train_valid_distributions(stats: dict, train_vids, valid_vids, task: int):
    """(n_train, train class distribution, n_valid, valid distribution),
    distributions normalised to sum 1 (get_train_valid_classes_from_split,
    data_class_analysis.py:101-113)."""
    out = []
    for vids in (train_vids, valid_vids):
        rows = np.isin(stats["vids"], list(vids))
        counts = stats["sums"][task][rows].sum(axis=0)
        out.extend([int(stats["frames"][rows].sum()), counts / max(counts.sum(), 1.0)])
    return out


def evaluate_permutation(df: FrameTable, perm: list[int],
                         thresholds=(0.75, 0.95, 1.9, 0.35), stats: dict | None = None):
    """5-fold evaluation of one permutation (data_class_analysis.py:277-318).

    Per fold (5 validation videos, 20 training): the training frame share
    must lie in [t0, t1], each testable class's relative train/valid
    distribution difference must stay < t2 and its mean < t3. `stats`
    (`video_counts(df)`) may be given to save its pass over the table.
    Returns (split_percentages (5,), closeness {task: (5, C)}, passing)."""
    t0, t1, t2, t3 = thresholds
    stats = stats or video_counts(df)
    split_pct = np.zeros(5)
    closeness = {t: np.zeros((5, taxonomy.num_label_values(t))) for t in (1, 2, 3)}
    passing = True
    for i in range(5):
        valid_vids = perm[i * 5:(i + 1) * 5]
        train_vids = sorted(set(perm) - set(valid_vids))
        for task in (1, 2, 3):
            n_tr, d_tr, n_va, d_va = _train_valid_distributions(
                stats, train_vids, valid_vids, task)
            split_pct[i] = n_tr / (n_tr + n_va)
            divisor = np.where(d_tr == 0, 1e-5, d_tr)
            c = np.abs(d_tr - d_va) / divisor
            closeness[task][i] = c
            testable = sorted(set(range(len(c))) - set(IMPOSSIBLE_CLASSES[task]))
            ok = (t0 <= split_pct[i] <= t1 and np.all(c[testable] < t2)
                  and np.mean(c[testable]) < t3)
            passing = passing and ok
    return split_pct, closeness, passing


def split_search(df: FrameTable, tries: int = 10_000,
                 thresholds=(0.75, 0.95, 1.9, 0.35), seed: int = 0,
                 verbose: bool = True) -> list[dict]:
    """Random search over rare-class-balanced permutations
    (split_permutator, data_class_analysis.py:242-275)."""
    rng = np.random.default_rng(seed)
    stats = video_counts(df)
    valid = []
    for i in range(tries):
        perm = permutation_candidate(rng)
        pct, closeness, passing = evaluate_permutation(df, perm, thresholds, stats)
        if passing:
            valid.append({"permutation": perm, "split_percentages": pct,
                          "mean_closeness": {t: float(np.mean(c))
                                             for t, c in closeness.items()}})
            if verbose:
                print(f"\nvalid permutation ({i}): {perm} "
                      f"splits {np.round(pct, 3).tolist()}")
        elif verbose and i % 200 == 0:
            print(f"\rtesting permutation {i}", end="", flush=True)
    if verbose:
        print(f"\n{len(valid)} valid / {tries} tried")
    return valid


# ---------------------------------------------------------------------------
# Label overlay checker (data_checker, data_class_analysis.py:369-387)
# ---------------------------------------------------------------------------

def check_labels(df: FrameTable, data_path: str, task: int = 0,
                 out_dir: str | None = None, limit: int | None = None):
    """Write img/label overlay images for manual label inspection: 25% label
    colormap over 75% image, class boundaries (colormap gradient) in black,
    into `comb_images/` as the reference's data_checker does. The JAX tool
    writes them through cv2 (BGR); these are the same pixels as RGB PNGs.
    Frames whose image or label is missing or not a readable PNG are
    skipped."""
    root = pathlib.Path(data_path)
    out = pathlib.Path(out_dir) if out_dir else root / "comb_images"
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for i in range(len(df))[:limit]:
        row = df.row(i)
        try:
            img = read_png(root / row["img_path"], 3)
            lbl = read_png(root / row["lbl_path"], 1)   # gray, as cv2's flag 0
        except (OSError, ValueError):
            continue
        remapped = remap_mask_np(lbl, task) if task > 0 else lbl
        lbl_img = mask_to_colormap(remapped, task)
        grad = sum(np.linalg.norm(np.gradient(lbl_img[..., ch].astype(np.float64)),
                                  axis=0) for ch in range(3))
        res = np.round(lbl_img * 0.25 + img * 0.75)
        res[grad > 0] = 0
        name = pathlib.PurePath(row["img_path"]).parts[-1]
        write_png(out / name, res.astype(np.uint8))
        written.append(name)
    return written


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--csv", default=None)
    p.add_argument("--split", type=int, default=2)
    p.add_argument("--search-splits", type=int, default=0, metavar="TRIES",
                   help="run the 5-fold video-permutation search")
    p.add_argument("--thresholds", type=float, nargs=4,
                   default=(0.75, 0.95, 1.9, 0.35))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--check-labels", metavar="DATA_PATH", default=None,
                   help="write label/image overlay images for inspection")
    p.add_argument("--task", type=int, default=0)
    p.add_argument("--limit", type=int, default=None)
    args = p.parse_args(argv)
    df = load_frame_table(args.csv)
    if args.search_splits:
        split_search(df, args.search_splits, tuple(args.thresholds), args.seed)
        return
    if args.check_labels:
        n = check_labels(df, args.check_labels, args.task, limit=args.limit)
        print(f"wrote {len(n)} overlay images")
        return
    for task in (1, 2, 3):
        print(f"--- task {task} class distribution ---")
        print(class_distribution(df, task).to_string(float_format="%.4f"))
    print(f"--- split {args.split} quality ---")
    for k, v in split_quality(df, args.split).items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main(sys.argv[1:])
