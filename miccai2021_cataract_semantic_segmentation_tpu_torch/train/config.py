"""Run-config reading: the JSON file and the EncDec graph rule.

Port of the part of the JAX package's train/config.py that a run needs
today: EncDec configs (configs/UPN_rf_lvsz.json) put `encoder` and
`decoder` at the top level and have no `graph` section, and `load_config`
gives them one. The defaults overlay, `path_info.json` and the CLI
overrides come with the Trainer (ROADMAP Queue A item 8).
"""
from __future__ import annotations

import json


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
