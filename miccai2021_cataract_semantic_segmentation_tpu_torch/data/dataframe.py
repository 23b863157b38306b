"""CaDIS frame-table handling without pandas: data.csv loading, video splits,
relabelled substitution, blacklist filtering, per-task class-pixel columns.

Port of the JAX package's data/dataframe.py (the reference's
BaseManager.get_seg_dataframes and utils.get_class_info). The table is read
with `csv` into a `FrameTable`: numpy columns (int64 where every cell is an
integer, float64 with NaN for blanks where every non-blank cell is a
number, object strings otherwise, as pandas' `read_csv` types them), with
`len`, column and row access and a boolean-mask select. A CSV's unnamed
first column is named "Unnamed: 0", as pandas names it. `to_csv` writes
what pandas' `to_csv(index=False)` writes, byte for byte, and `to_string`
prints what its `to_string(index=False)` prints.

`load_frame_table` searches, in order: an explicit path, $CADIS_DATA_CSV,
<data_path>/data.csv, <repo>/data/data.csv.
"""
from __future__ import annotations

import csv
import os
import pathlib

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy

_REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]


def _column(cells: list[str]) -> np.ndarray:
    """One CSV column as pandas' `read_csv` types it (int64, float64 with
    NaN for blanks, or object strings with None for blanks)."""
    filled = [c for c in cells if c != ""]
    try:
        ints = [int(c) for c in filled]
    except ValueError:
        ints = None
    if ints is not None and len(filled) == len(cells):
        return np.asarray(ints, dtype=np.int64)
    try:
        return np.asarray([float(c) if c != "" else np.nan for c in cells],
                          dtype=np.float64)
    except ValueError:
        return np.asarray([c if c != "" else None for c in cells], dtype=object)


class FrameTable:
    """An ordered set of equal-length named numpy columns, one row a frame."""

    def __init__(self, columns: dict[str, np.ndarray]):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
        self._cols = dict(columns)

    @classmethod
    def read_csv(cls, path) -> "FrameTable":
        with open(path, newline="") as f:
            rows = list(csv.reader(f))
        header, body = rows[0], rows[1:]
        names = [h if h else f"Unnamed: {i}" for i, h in enumerate(header)]
        for k, r in enumerate(body):
            if len(r) != len(names):
                raise ValueError(f"{path}: row {k + 1} has {len(r)} cells, "
                                 f"the header {len(names)}")
        return cls({n: _column([r[i] for r in body]) for i, n in enumerate(names)})

    @property
    def columns(self) -> list[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def row(self, i: int) -> dict:
        """Row `i` as {column: value}."""
        return {k: v[i] for k, v in self._cols.items()}

    def select(self, mask) -> "FrameTable":
        """The rows where the boolean `mask` holds, in order (copies)."""
        mask = np.asarray(mask, dtype=bool)
        return FrameTable({k: v[mask].copy() for k, v in self._cols.items()})

    def take(self, positions) -> "FrameTable":
        """The rows at `positions`, in that order (copies)."""
        pos = np.asarray(positions, dtype=np.int64)
        return FrameTable({k: v[pos].copy() for k, v in self._cols.items()})

    def with_column(self, name: str, values, first: bool = False) -> "FrameTable":
        """A table with column `name` set to `values`, placed first or last."""
        cols = {k: v for k, v in self._cols.items() if k != name}
        new = {name: np.asarray(values)}
        return FrameTable({**new, **cols} if first else {**cols, **new})

    def set_column(self, name: str, values) -> "FrameTable":
        """A table with column `name` set to `values`: in its place where it
        exists, else last (pandas' `df[name] = values`)."""
        return FrameTable({**self._cols, name: np.asarray(values)})

    def to_csv(self, path) -> None:
        """Write the table as pandas' `to_csv(index=False)` writes it: a
        header row, then each row; integers and strings as they are,
        floats by `repr` with NaN and None blank, bools as True/False,
        minimal quoting, "\\n" line ends."""
        with open(path, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(self.columns)
            cols = [[_cell(x) for x in v] for v in self._cols.values()]
            w.writerows(zip(*cols))

    def to_string(self, float_format: str | None = None) -> str:
        """The table as pandas' `to_string(index=False, float_format=...)`
        prints it: every column right-justified to its widest cell, the
        columns two spaces apart; floats by `float_format` (NaN as NaN)."""
        def text(x):
            if isinstance(x, (float, np.floating)):
                return "NaN" if np.isnan(x) else \
                    (float_format % x if float_format else repr(float(x)))
            return _cell(x)

        cols = []
        for name, v in self._cols.items():
            cells = [name] + [text(x) for x in v]
            width = max(map(len, cells))
            cols.append([c.rjust(width) for c in cells])
        return "\n".join("  ".join(row) for row in zip(*cols))


def _cell(x) -> str:
    """One value as pandas' `to_csv` writes it."""
    if x is None:
        return ""
    if isinstance(x, (bool, np.bool_)):
        return str(bool(x))
    if isinstance(x, (float, np.floating)):
        return "" if np.isnan(x) else repr(float(x))
    return str(x)


def load_frame_table(path: str | None = None,
                     data_path: str | None = None) -> FrameTable:
    candidates = [path, os.environ.get("CADIS_DATA_CSV")]
    if data_path:
        # a user-curated table in the dataset tree wins over the vendored one
        candidates.append(pathlib.Path(data_path) / "data.csv")
    candidates.append(_REPO_ROOT / "data" / "data.csv")
    for c in candidates:
        if c and pathlib.Path(c).is_file():
            return FrameTable.read_csv(c)
    raise FileNotFoundError(
        "CaDIS frame table (data.csv) not found; set CADIS_DATA_CSV or pass "
        "config['data']['data_csv']")


def _sample(n: int, frac: float, seed: int) -> np.ndarray:
    """Row positions of pandas' `DataFrame.sample(frac=frac,
    random_state=seed)` on n rows: round(frac * n) positions drawn without
    replacement by `np.random.RandomState(seed).choice`."""
    return np.random.RandomState(seed).choice(n, size=round(frac * n),
                                              replace=False)


def split_dataframes(df: FrameTable, split: int, mode: str = "training",
                     use_relabeled: bool = False, blacklist: bool = True,
                     random_split=None, seed: int = 0,
                     ) -> tuple[FrameTable, FrameTable]:
    """(train, valid) frame tables for a video split.

    For 3-way splits, `mode == 'inference'` swaps the validation videos for
    the test videos. `random_split=[f_train, f_valid]` is the legacy
    frame-level random split, drawn as pandas' `sample` draws it. Each
    result has an `index` column first, the rows' positions in `df` (what
    pandas' `reset_index` leaves)."""
    pos = np.arange(len(df))
    if random_split is not None:
        train_pos = pos[_sample(len(df), random_split[0], seed)]
        rest = np.setdiff1d(pos, train_pos, assume_unique=True)   # in order
        frac = random_split[1] / (1 - random_split[0])
        valid_pos = rest[_sample(len(rest), frac, seed)]
    else:
        spl = taxonomy.DATA_SPLITS[int(split)]
        if len(spl) == 2:
            train_videos, valid_videos = spl
        else:
            train_videos, valid_videos, test_videos = spl
            if mode == "inference":
                valid_videos = test_videos
        vid = df["vid_num"]
        train_pos = pos[np.isin(vid, train_videos)]
        valid_pos = pos[np.isin(vid, valid_videos)]

    parts = []
    for part_pos in (train_pos, valid_pos):
        part = df.take(part_pos).with_column("index", part_pos, first=True)
        if use_relabeled:
            relabeled = part["relabeled"] == 1
            part["blacklisted"][relabeled] = 0   # keep the corrected frame
            lbl = part["lbl_path"]
            for i in np.nonzero(relabeled)[0]:
                lbl[i] = "relabeled/" + pathlib.PurePath(lbl[i]).name
        if blacklist:
            part = part.select(part["blacklisted"] != 1)
        parts.append(part)
    return parts[0], parts[1]


def canonical_count_matrix(df: FrameTable) -> np.ndarray:
    """(n_frames, 36) per-frame canonical-class pixel counts from the named
    columns of the frame table."""
    return np.stack([np.asarray(df[c], dtype=np.float64)
                     for c in taxonomy.CANONICAL_NAMES], axis=1)


def task_count_matrix(df: FrameTable, task: int) -> np.ndarray:
    """(n_frames, num_classes[+ignore]) per-frame pixel counts in task space."""
    canon = canonical_count_matrix(df)
    n_out = taxonomy.num_label_values(task)
    out = np.zeros((len(df), n_out))
    for task_id, canon_ids in taxonomy.TASK_GROUPS[task].items():
        col = n_out - 1 if task_id == taxonomy.IGNORE_VALUE else task_id
        out[:, col] += canon[:, list(canon_ids)].sum(axis=1)
    return out
