"""Join the frame table's blacklist column onto a label table (the port's
counterpart of the repository's tools/add_blacklist.py, the reference's
utils/add_blacklist_to_label_table.py, without pandas):

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.add_blacklist \
        --label-table label_table.csv --csv data/data.csv -o label_table_with_blacklist.csv

Row i of the label table takes row i's `blacklisted` (pandas' join on the
row index: a table longer than the frame table gets blanks). Where the
label table has a `file_name` column, each row's name must be part of the
frame table's `img_path` of that row.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (
    FrameTable, load_frame_table)


def add_blacklist(lt: FrameTable, data: FrameTable) -> FrameTable:
    """`lt` with `data`'s blacklisted column joined on the row index."""
    src = data["blacklisted"]
    if len(src) >= len(lt):
        col = src[:len(lt)].copy()
    else:                              # the rows beyond the frame table: NaN
        col = np.full(len(lt), np.nan)
        col[:len(src)] = src
    lt = lt.set_column("blacklisted", col)
    if "file_name" in lt:
        for ind, (name, path) in enumerate(zip(lt["file_name"], data["img_path"])):
            name = "nan" if name is None else name      # pandas reads a blank as NaN
            if str(name) not in str(path):             # the JAX tool's assert
                raise AssertionError(
                    f"row {ind}: label-table file {name} does not match {path}")
    return lt


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--label-table", required=True)
    p.add_argument("--csv", default=None)
    p.add_argument("-o", "--out", required=True)
    args = p.parse_args(argv)
    lt = add_blacklist(FrameTable.read_csv(args.label_table), load_frame_table(args.csv))
    lt.to_csv(args.out)
    print(f"{len(lt)} rows -> {args.out}")


if __name__ == "__main__":
    main(sys.argv[1:])
