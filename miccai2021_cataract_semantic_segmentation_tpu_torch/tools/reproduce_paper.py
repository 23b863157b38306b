"""Turn-key reproduction of the paper's headline test mIoU on the port (the
counterpart of the repository's tools/reproduce_paper.py).

The reference publishes OCRNet-R50-os8 checkpoints reaching 86.40 / 79.40 /
71.94 test mIoU on CaDIS tasks 1/2/3 (split 2 train-val-test, no
blacklist, no relabelled data; inference recipe
configs/OCRNet_pretrained_t{1,2,3}.json). With the CaDIS dataset and the
published .pt files at hand, the whole acceptance is one command:

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.reproduce_paper \
        --data-root /path/to/CaDIS \
        --ckpt 1=/path/to/t1/chkpt_best.pt \
        --ckpt 2=/path/to/t2/chkpt_best.pt \
        --ckpt 3=/path/to/t3/chkpt_best.pt [--device cuda|cuda:N|cpu]

Per task it parses the shipped configs/OCRNet_pretrained_t{k}.json (mode
inference: split 2's test videos, no blacklist or relabelled frames),
loads the reference's state dict into the port's OCRNet
(`torch_checkpoint`), runs the port Trainer's batched full-coverage
`infer` (the reference's flip + multi-scale TTA with --tta; the published
numbers are without it) and prints the mIoU table against the paper's.
It runs on the card unless given `--device cpu`; without a card it
raises.

Exit code 0 iff every evaluated task is within --tolerance (default 0.5
mIoU points) of the paper's number, 1 otherwise, 2 when no task ran.
`--dry-table` prints the table with blank results (a wiring check).

Test hooks (--backbone/--data-csv/--max-frames) run the same code path end
to end on synthetic frames and a synthetic .pt; they do not change the
default, paper-faithful behaviour.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

import numpy as np

PAPER_MIOU = {1: 86.40, 2: 79.40, 3: 71.94}
CONFIGS = pathlib.Path(__file__).resolve().parents[2] / "configs"


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--data-root", required=True,
                   help="CaDIS dataset root (the directory holding "
                        "Video01..Video25)")
    p.add_argument("--ckpt", action="append", default=[],
                   metavar="TASK=PATH",
                   help="published checkpoint per task, e.g. 1=/x/t1.pt "
                        "(repeat for each task)")
    p.add_argument("--tta", action="store_true",
                   help="flip + multi-scale TTA merge (BaseManager.py:652-"
                        "660); the paper table numbers are WITHOUT TTA")
    p.add_argument("--tolerance", type=float, default=0.5,
                   help="pass/fail band in mIoU points (default 0.5)")
    p.add_argument("--valid-batch-size", type=int, default=None,
                   help="eval batch size (default: auto, 8 on the card)")
    p.add_argument("--log-path", default="logs")
    p.add_argument("--device", default="cuda",
                   help="where inference runs (default: cuda; cpu for the host)")
    p.add_argument("--dry-table", action="store_true",
                   help="print the table without running anything")
    # --- test hooks (suite only; defaults are paper-faithful) -----------
    p.add_argument("--backbone", default=None, help=argparse.SUPPRESS)
    p.add_argument("--data-csv", default=None, help=argparse.SUPPRESS)
    p.add_argument("--max-frames", type=int, default=None,
                   help=argparse.SUPPRESS)
    return p


def _parse_ckpts(specs) -> dict[int, str]:
    out = {}
    for s in specs:
        task, _, path = s.partition("=")
        if not path:
            raise SystemExit(f"--ckpt expects TASK=PATH, got '{s}'")
        try:
            tid = int(task)
        except ValueError:
            raise SystemExit(f"--ckpt task must be 1-3, got '{task}'")
        if tid not in PAPER_MIOU:
            raise SystemExit(f"--ckpt task must be 1-3, got {tid}")
        out[tid] = path
    return out


def task_config(task: int, ckpt_path: str, args) -> dict:
    """The shipped inference config of `task` with the checkpoint, the
    dataset, the log path, TTA and the test hooks set from `args`."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import parse_config

    config = parse_config(str(CONFIGS / f"OCRNet_pretrained_t{task}.json"), None, -1)
    config.pop("load_checkpoint", None)      # the reference .pt instead
    config["torch_checkpoint"] = str(ckpt_path)
    config["data_path"] = args.data_root
    config["log_path"] = args.log_path
    config["tta"] = bool(args.tta)
    config["run_id"] = f"reproduce_paper_t{task}"
    if args.valid_batch_size:
        config["valid_batch_size"] = args.valid_batch_size
    if args.backbone:                        # test hook
        config["graph"]["backbone"] = args.backbone
    if args.data_csv:                        # test hook
        config["data"]["data_csv"] = args.data_csv
    return config


def run_task(task: int, ckpt_path: str, args) -> dict:
    """Load + infer one task on `args.device`; the results of Trainer.infer."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import SegDataset
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer

    trainer = Trainer(task_config(task, ckpt_path, args), device=args.device)
    if args.max_frames:                      # test hook: cap the test set
        ds = trainer.valid_set
        n = min(args.max_frames, len(ds))
        trainer.valid_set = SegDataset(ds.df.take(np.arange(n)), ds.task, ds.data_path)
    try:
        return trainer.infer()
    finally:
        trainer.close()


def main(argv=None):
    args = build_argparser().parse_args(argv)
    ckpts = _parse_ckpts(args.ckpt)
    rows = []
    ok = True
    for task in (1, 2, 3):
        paper = PAPER_MIOU[task]
        if args.dry_table or task not in ckpts:
            rows.append((task, paper, None, None, "skipped (no --ckpt)"))
            continue
        res = run_task(task, ckpts[task], args)
        got = 100.0 * res["miou"]
        delta = got - paper
        passed = abs(delta) <= args.tolerance
        ok &= passed
        rows.append((task, paper, got, delta,
                     "PASS" if passed else f"FAIL (>{args.tolerance})"))

    print("\nCaDIS test-set mIoU vs the paper "
          "(README.md:104-106, split 2, OCRNet-R50-os8"
          + (", TTA)" if args.tta else ")"))
    print(f"{'task':<6}{'paper':>8}{'ours':>9}{'delta':>8}   status")
    for task, paper, got, delta, status in rows:
        got_s = f"{got:8.2f}" if got is not None else "       —"
        d_s = f"{delta:+7.2f}" if delta is not None else "      —"
        print(f"{task:<6}{paper:8.2f}{got_s}{d_s}   {status}")
    print(json.dumps({"results": [
        {"task": t, "paper_miou": p, "miou": g, "delta": d, "status": s}
        for t, p, g, d, s in rows]}))
    if args.dry_table:
        return
    if not any(r[2] is not None for r in rows):
        # a pass/fail gate must not exit 0 when nothing ran (no --ckpt given
        # or none matched a task): that would silently report success
        print("error: no task was evaluated — pass --ckpt TASK=PATH "
              "(or --dry-table for a wiring check)", file=sys.stderr)
        sys.exit(2)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
