"""Export a trained run as a standalone serving artifact (`.pt2`).

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.export_serving \
        -c configs/OCRNet_pretrained_t2.json [-dp <root>] [-r <run_id>] \
        [-w best|last] [-o out.pt2] [--batch N] [--device cuda|cuda:N|cpu] [--tta] \
        [--mesh N]

Builds the model from the config, restores the checkpoint (the config's
`load_checkpoint` run by default, as inference mode does) and writes one
`torch.export` artifact with the weights inside and a symbolic batch axis
(unless --batch pins it), beside a `.json` sidecar. The artifact runs on
the device it was exported on (`--device`, the card by default) under
torch alone; see train/export.py. The JAX package's `--platforms` is
`--device` here. `--mesh N` exports for serving the pinned batch over N
devices (cuda:0 .. cuda:N-1, or N copies of the CPU with `--device cpu`),
each on its contiguous shard: load it with
`train/export.py:load_serving(path, mesh=devices)`.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-dp", "--data_path", default=None,
                    help="dataset root (the CLI's flag)")
    ap.add_argument("-r", "--run_id", default=None,
                    help="run to restore (default: the config's load_checkpoint)")
    ap.add_argument("-w", "--which", default="best", choices=["best", "last"])
    ap.add_argument("-o", "--out", default=None)
    ap.add_argument("--batch", type=int, default=None,
                    help="pin the batch axis (default: symbolic)")
    ap.add_argument("--device", default="cuda",
                    help="the device to export for and to serve on (default: cuda)")
    ap.add_argument("--tta", action="store_true",
                    help="put the flip x multi-scale TTA recipe into the artifact")
    ap.add_argument("--mesh", type=int, default=None, metavar="N",
                    help="shard the batch over N devices (data-parallel "
                         "serving; requires --batch divisible by N)")
    args = ap.parse_args(argv)

    from miccai2021_cataract_semantic_segmentation_tpu_torch.train import export as exp
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import parse_config
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer

    config = parse_config(args.config)
    config["mode"] = "inference"
    if args.data_path:
        config["data_path"] = args.data_path
    is_ensemble = config.get("manager") == "Ensemble" or \
        (config.get("graph") or {}).get("model") == "Ensemble"
    run_id = args.run_id or config.get("load_checkpoint")
    if is_ensemble:
        # the members restore their own best checkpoints when they are built
        if args.run_id or args.which != "best":
            ap.error("-r/-w do not apply to Ensemble configs: members restore "
                     "their own 'best' checkpoints (set per-member 'ckpt' "
                     "run-ids in the config)")
        if args.tta:
            ap.error("--tta is a single-model recipe (BaseManager.infer); not "
                     "applicable to Ensemble configs")
    elif not run_id:
        ap.error("no checkpoint specified: pass -r <run_id> or set "
                 "'load_checkpoint' in the config")
    mesh = None
    if args.mesh:
        import torch
        if torch.device(args.device).type == "cpu":
            mesh = ["cpu"] * args.mesh
        elif args.mesh > torch.cuda.device_count():
            ap.error(f"--mesh {args.mesh} exceeds the {torch.cuda.device_count()} "
                     "available devices; the artifact's device assignment "
                     "must be built on the target parallelism")
        else:
            mesh = [f"cuda:{i}" for i in range(args.mesh)]
    trainer = Trainer(config, device=args.device)
    try:
        if not is_ensemble:
            trainer.load_checkpoint(args.which, run_id=run_id)
        out = args.out or (trainer.run_dir / f"serving_{args.which}{exp.SUFFIX}")
        path = exp.export_trainer(trainer, out, batch=args.batch, tta=args.tta,
                                  mesh=mesh)
    finally:
        trainer.close()
    print(f"exported {path} ({path.stat().st_size / 1e6:.1f} MB) for {trainer.device}")
    return path


if __name__ == "__main__":
    main(sys.argv[1:])
