"""Build the CaDIS frame table (data.csv) from a dataset directory tree (the
port's counterpart of the repository's tools/build_frame_table.py, without
pandas or PIL).

The reference's utils/df_from_data.py (the path listing) and
utils/data_class_analysis.py:get_class_numbers (each frame's pixel count
of every canonical class) in one pass:

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.build_frame_table \
        --path /path/to/cadis -o data/data.csv [--no-pixel-counts]

Expected tree: <path>/VideoXX/Images/*.png and <path>/VideoXX/Labels/*.png
(labels are 8-bit canonical ids 0..35; of an RGB label, channel 0). The
columns are vid_num, img_path, lbl_path, per_video_index, blacklisted,
relabeled and then the canonical class names; the rows are sorted by
(vid_num, img_path); the CSV is byte-equal to the JAX tool's.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import FrameTable
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.png import read_png

COLUMNS = ("vid_num", "img_path", "lbl_path", "per_video_index", "blacklisted",
           "relabeled")


def build_frame_table(data_path: pathlib.Path, count_pixels: bool = True) -> FrameTable:
    data_path = pathlib.Path(data_path)
    records = []
    videos = sorted(f for f in data_path.iterdir()
                    if f.is_dir() and f.name.startswith("Video"))
    for folder in videos:
        vid_num = int(folder.name[-2:])
        images = sorted((folder / "Images").iterdir())
        for k, image in enumerate(images):
            lbl_path = str(pathlib.PurePosixPath(folder.name) / "Labels" / image.name)
            rec = [vid_num, str(pathlib.PurePosixPath(folder.name) / "Images" / image.name),
                   lbl_path, k, 0, 0]
            if count_pixels:
                lbl = read_png(data_path / lbl_path, 3)[..., 0]
                counts = np.bincount(lbl.reshape(-1), minlength=256)
                if counts[taxonomy.NUM_CANONICAL:].sum():
                    raise ValueError(f"{lbl_path}: ids outside 0..35 found")
                rec.extend(counts[:taxonomy.NUM_CANONICAL].tolist())
            records.append(rec)
    if not records:
        raise ValueError(f"{data_path}: no VideoXX/Images/ frames")
    records.sort(key=lambda r: (r[0], r[1]))
    names = COLUMNS + (tuple(taxonomy.CANONICAL_NAMES) if count_pixels else ())
    return FrameTable({name: np.asarray([r[i] for r in records],
                                        dtype=object if name in ("img_path", "lbl_path")
                                        else np.int64)
                       for i, name in enumerate(names)})


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("-p", "--path", required=True, help="CaDIS dataset root")
    p.add_argument("-o", "--out", default="data/data.csv")
    p.add_argument("--no-pixel-counts", action="store_true",
                   help="skip label decoding (paths only, like df_from_data.py)")
    args = p.parse_args(argv)
    df = build_frame_table(pathlib.Path(args.path), not args.no_pixel_counts)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(out)
    print(f"{len(df)} frames x {len(np.unique(df['vid_num']))} videos -> {out}")


if __name__ == "__main__":
    main(sys.argv[1:])
