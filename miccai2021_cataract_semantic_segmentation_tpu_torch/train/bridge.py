"""flax -> torch weight bridge for OCRNet.

The inverse of the JAX package's train/port_torch.py (`port_ocrnet`,
`port_resnet_backbone`, `_resnet_flax_path`): it takes a flax `params` /
`batch_stats` tree given as nested dicts of numpy arrays and returns the
port's state dict under the reference's torch names. Conv kernels go HWIO
-> OIHW; BatchNorm scale/bias/mean/var go to weight/bias/running_mean/
running_var, and each BatchNorm gets a `num_batches_tracked` of 0, so the
result loads with `load_state_dict(strict=True)`.
"""
from __future__ import annotations

import re

import numpy as np
import torch

# OCRNet head modules: flax module path -> torch module prefix
_HEAD = {
    ("interm_conv", "conv"): "interm_prediction_head.0",
    ("interm_conv", "bn"): "interm_prediction_head.1",
    ("interm_cls",): "interm_prediction_head.4",
    ("conv_high_map", "conv"): "conv_high_map.0",
    ("conv_high_map", "bn"): "conv_high_map.1",
    ("ocr", "fuse", "conv"): "spatial_ocr_head.conv_bn_dropout.0",
    ("ocr", "fuse", "bn"): "spatial_ocr_head.conv_bn_dropout.1",
    ("conv_out",): "conv_out",
}
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _module_prefix(path: tuple[str, ...]) -> str:
    """flax module path -> torch module prefix."""
    if path[0] == "backbone":
        out = []
        for m in path[1:]:
            hit = re.fullmatch(r"(layer\d+|downsample)_(\d+)", m)
            out.append(f"{hit.group(1)}.{hit.group(2)}" if hit else m)
        return "backbone." + ".".join(out)
    if path[:2] == ("ocr", "attn"):
        i = int(path[3][-1])                   # conv{i} / bn{i}
        idx = 3 * i + (1 if path[3].startswith("bn") else 0)
        return f"spatial_ocr_head.object_context_block.{path[2]}.{idx}"
    if path in _HEAD:
        return _HEAD[path]
    raise KeyError(f"no torch name for flax module {path}")


def _walk(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def bridge_ocrnet(params, batch_stats) -> dict[str, torch.Tensor]:
    """flax OCRNet params/batch_stats -> the port's OCRNet state dict."""
    sd: dict[str, torch.Tensor] = {}
    bn_modules = []
    for tree in (params, batch_stats):
        for path, v in _walk(tree):
            prefix = _module_prefix(path[:-1])
            leaf = path[-1]
            if leaf == "kernel":
                v = np.transpose(v, (3, 2, 0, 1))       # HWIO -> OIHW
            elif leaf == "scale":
                bn_modules.append(prefix)
            sd[f"{prefix}.{_LEAF[leaf]}"] = torch.from_numpy(np.array(v, order="C"))
    for prefix in bn_modules:
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd
