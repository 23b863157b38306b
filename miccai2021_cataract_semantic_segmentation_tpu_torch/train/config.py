"""Config system: JSON run configs + defaults overlay + CLI overrides.

Port of the JAX package's train/config.py (the reference's
utils/utils.py:509-544 and utils/defaults.py:334-408): a run config JSON
with `manager`, `graph`, `data`, `loss`, `train` sections; a
`path_info.json` beside it mapping user codes to [data_path, log_path];
flat defaults merged first, nested sections reset to their defaults and
then updated. `load_config` reads a file with only the EncDec graph rule
(configs/UPN_rf_lvsz.json puts `encoder` and `decoder` at the top level
and has no `graph` section), as the chip smoke run and the tests use it.
"""
from __future__ import annotations

import copy
import json
import pathlib

DEFAULT_CONFIG_FLAT = {
    "mode": "training",
    "debugging": False,
    "log_every_n_epochs": 100,
    "max_valid_imgs": 10,
    "seed": 0,
    "tta": False,
    "device": 0,
    "log_every_n_steps": 50,
    # None = auto: 8 on the card, 1 on the CPU (Trainer)
    "valid_batch_size": None,
    "precision": "bf16",
}

DEFAULT_CONFIG_NESTED = {
    "data": {
        "transforms": ["pad"],
        "transform_values": {"crop_size": 0.4, "crop_mode": "random"},
        "split": 1,
        "batch_size": 10,
        "num_workers": 0,
        "preload": False,
        "blacklist": True,
        "use_relabeled": False,
        "weighted_random": [0, 0],
        "weighted_random_mode": "v1",
        "oversampling": [0, 0],
        "oversampling_frac": 0.2,
        "oversampling_preset": "default",
        "adaptive_batching": [0, 0],
        "adaptive_sel_size": 10,
        "adaptive_iou_update": 1,
        "repeat_factor": [0, 0],
        "repeat_factor_freq_thresh": 0.2,
    },
    "train": {
        "epochs": 50,
        "lr_fct": "exponential",
        "lr_batchwise": False,
        "lr_restarts": [],
        "lr_restart_vals": 1,
        "lr_params": None,
        "learning_rate": 1e-4,
    },
    "loss": {},
}


def with_encdec_graph(cfg: dict) -> dict:
    """`cfg` with `graph` = {"model": "EncDec", "encoder": ..., "decoder":
    ...} when it has a top-level `encoder` and no `graph`; else `cfg`."""
    if "graph" in cfg or "encoder" not in cfg:
        return cfg
    return dict(cfg, graph={"model": "EncDec", "encoder": cfg["encoder"],
                            "decoder": cfg.get("decoder", {"model": "UPerNet"})})


def load_config(path) -> dict:
    """The run config at `path`, with the EncDec graph rule applied."""
    with open(path) as f:
        return with_encdec_graph(json.load(f))


def parse_config(file_path: str, user: str | None = None,
                 device: int = -1) -> dict:
    """The run config at `file_path` over the defaults, with `user`'s
    [data_path, log_path] from the `path_info.json` beside it."""
    with open(file_path) as f:
        cfg = json.load(f)
    path_info_file = pathlib.Path(file_path).parent / "path_info.json"
    if path_info_file.is_file() and user:
        with open(path_info_file) as f:
            path_info = json.load(f)
        if user in path_info:
            cfg["data_path"] = path_info[user][0]
            cfg["log_path"] = path_info[user][1]
            ss = path_info.get(f"ss_pretrained_{user}")
            if ss:
                cfg["ss_pretrained_path"] = ss[0]
    if device >= 0:
        cfg["device"] = device

    merged = dict(DEFAULT_CONFIG_FLAT)
    merged.update(cfg)
    for section, defaults in DEFAULT_CONFIG_NESTED.items():
        base = copy.deepcopy(defaults)
        base.update(cfg.get(section, {}))
        merged[section] = base
    merged.setdefault("data_path", None)
    merged.setdefault("log_path", "logs")
    merged["data"].setdefault("experiment", 1)
    merged["data"]["transform_values"]["experiment"] = merged["data"]["experiment"]
    return with_encdec_graph(merged)


def apply_cli_overrides(config: dict, args) -> dict:
    """The CLI's -t task, -bs batch size, -dp data path, -bl (no
    blacklist) and -rl (use relabelled) flags over `config`."""
    if getattr(args, "task", None):
        config["data"]["experiment"] = int(args.task)
        config["data"]["transform_values"]["experiment"] = int(args.task)
    if getattr(args, "batch_size", None):
        config["data"]["batch_size"] = int(args.batch_size)
    if getattr(args, "data_path", None):
        config["data_path"] = args.data_path
    if getattr(args, "no_blacklist", False):
        config["data"]["blacklist"] = False
    if getattr(args, "use_relabeled", False):
        config["data"]["use_relabeled"] = True
    return config
