"""CLI entry point of the port, with the reference's flags:

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.main \
        -c configs/OCRNet_pretrained_t2.json [-t 2] [-u user] [-d 0]
        [-dp /path/to/cadis] [-bs 8] [-bl] [-rl]

The command line always runs on the card: `-d N` selects cuda:N (cuda
without it). `main(argv, device=...)` takes another device for callers
such as the tests. Modes (config['mode']): training (`Trainer.train`,
resumed from the `last` checkpoint of the run that `load_checkpoint`
names, where the config names one), inference (the best checkpoint of
that run, then `Trainer.infer`, with TTA where the config sets `tta`) and
video_inference / demo_video_inference (the best checkpoint, then
train/video.py:demo_infer over the config's `video_ids`).
"""
from __future__ import annotations

import argparse
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="CaDIS segmentation on the GPU")
    p.add_argument("-c", "--config", required=True, help="run config JSON")
    p.add_argument("-u", "--user", default=None, help="path_info.json user code")
    p.add_argument("-d", "--device", type=int, default=-1, help="CUDA device index")
    p.add_argument("-t", "--task", type=int, default=None,
                   help="CaDIS task / experiment (1, 2, 3)")
    p.add_argument("-dp", "--data_path", default=None, help="dataset root")
    p.add_argument("-bs", "--batch_size", type=int, default=None)
    p.add_argument("-bl", "--no_blacklist", action="store_true",
                   help="disable blacklisting")
    p.add_argument("-rl", "--use_relabeled", action="store_true",
                   help="use relabelled data")
    return p


def main(argv=None, device=None) -> dict:
    """Run the config's mode; returns the run's metrics."""
    args = build_argparser().parse_args(argv)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import (
        apply_cli_overrides, parse_config)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer

    config = apply_cli_overrides(parse_config(args.config, args.user, args.device),
                                 args)
    if device is None:
        device = f"cuda:{args.device}" if args.device >= 0 else "cuda"
    mode = config.get("mode", "training")
    video = mode in ("video_inference", "demo_video_inference")
    if mode not in ("training", "inference") and not video:
        raise ValueError(f"Unknown mode '{mode}'")
    trainer = Trainer(config, device=device)
    try:
        if config.get("load_checkpoint"):
            trainer.load_checkpoint("last" if mode == "training" else "best",
                                    run_id=config["load_checkpoint"])
        if video:
            from miccai2021_cataract_semantic_segmentation_tpu_torch.train.video import (
                demo_infer)
            return demo_infer(trainer)
        return trainer.train() if mode == "training" else trainer.infer()
    finally:
        trainer.close()


if __name__ == "__main__":
    main(sys.argv[1:])
