"""flax -> torch weight bridge for OCRNet, HRNetv2, DeepLabv3, DeepLabv3+ and
EncDec-UPerNet, with their projection heads.

The inverse of the JAX package's train/port_torch.py (`port_ocrnet`,
`port_resnet_backbone`, `_resnet_flax_path`, `port_hrnet`,
`port_deeplabv3`, `port_deeplabv3plus`, `port_encdec_upernet`): it takes a
flax `params` /
`batch_stats` tree given as nested dicts of numpy arrays and returns the
port's state dict under the reference's torch names. Conv kernels go HWIO
-> OIHW; BatchNorm scale/bias/mean/var go to weight/bias/running_mean/
running_var, and each BatchNorm gets a `num_batches_tracked` of 0, so the
result loads with `load_state_dict(strict=True)`. `port_torch.py` has no
table for the projection head; its flax modules `projector/mlp_{i}`,
`projector/mlp_bn_{i}` and `projector/out` go to the port's own names
`projector.mlp_{i}`, `projector.mlp_bn_{i}` and `projector.out`
(models/projector.py).
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


def _block_prefix(path) -> str:
    """A ResNet block's flax path ("layer1_0", "downsample_1", ...) ->
    its torch names ("layer1.0", "downsample.1", ...)."""
    out = []
    for m in path:
        hit = re.fullmatch(r"(layer\d+|downsample)_(\d+)", m)
        out.append(f"{hit.group(1)}.{hit.group(2)}" if hit else m)
    return ".".join(out)


def _projector_prefix(path: tuple[str, ...]) -> str:
    """The projection head's flax module path -> torch module prefix."""
    return f"projector.{path[1]}"


def _ocrnet_prefix(path: tuple[str, ...]) -> str:
    """OCRNet's flax module path -> torch module prefix."""
    if path[0] == "projector":
        return _projector_prefix(path)
    if path[0] == "backbone":
        return "backbone." + _block_prefix(path[1:])
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


_CONV_BN = {"conv": "0", "bn": "1"}


def _hrnet_prefix(path: tuple[str, ...]) -> str:
    """HRNetv2's flax module path -> torch module prefix (the inverse of
    `port_hrnet`)."""
    head, rest = path[0], path[1:]
    if head in ("stem1", "stem2"):
        return rest[0] + head[-1]               # conv1, bn1, conv2, bn2
    if head.startswith("layer1_"):
        return _block_prefix(path)
    hit = re.fullmatch(r"trans(\d)_(\d)", head)
    if hit:                              # branch i of stage s
        s, i = int(hit.group(1)), int(hit.group(2))
        new = ".0" if i >= s - 1 else ""  # a new branch's extra Sequential
        return f"transition{s - 1}.{i}{new}.{_CONV_BN[rest[0]]}"
    if head.startswith("stage"):
        base = f"{head}.0"
        hit = re.fullmatch(r"branch(\d)", rest[0])
        if hit:
            return (f"{base}.branches.{hit.group(1)}.{rest[1][len('block'):]}."
                    + _block_prefix(rest[2:]))
        ij = rest[0][len("fuse"):].split("_")     # fuse{i}_{j}[_{k}]
        return f"{base}.fuse_layers.{'.'.join(ij)}.{_CONV_BN[rest[1]]}"
    if head == "head":
        return f"last_layer.{_CONV_BN[rest[0]]}"
    if head == "cls":
        return "last_layer.3"
    raise KeyError(f"no torch name for flax module {path}")


def _deeplab_prefix(path: tuple[str, ...], plus: bool) -> str:
    """DeepLabv3(+)'s flax module path -> torch module prefix: the ASPP's
    bare convolutions beside their `*_bn`, the v3+ decoder's likewise."""
    head = path[0]
    if head == "projector":
        return _projector_prefix(path)
    if head == "backbone":
        return "backbone." + _block_prefix(path[1:])
    if head == "conv_out":
        return "decoder.conv_out" if plus else "conv_out"
    if head == "aspp":
        name, part = path[1], path[2]
        if name == "proj":
            return "aspp." + ("conv2" if part == "conv" else "bn2")
        return f"aspp.{name}" + ("" if part == "conv" else "_bn")
    if plus and head in ("conv_low", "conv_3x3_1", "conv_3x3_2"):
        return f"decoder.{head}" + ("" if path[1] == "conv" else "_bn")
    raise KeyError(f"no torch name for flax module {path}")


def _encdec_upernet_prefix(path: tuple[str, ...]) -> str:
    """EncDec-UPerNet's flax module path -> torch module prefix (the
    inverse of `port_encdec_upernet` and its `_upernet_table`)."""
    head, rest = path[0], path[1:]
    if head == "projector":
        return _projector_prefix(path)
    if head == "encoder":
        return "enc_model." + _block_prefix(rest)
    if head != "decoder":
        raise KeyError(f"no torch name for flax module {path}")
    if rest == ("cls",):
        return "dec_model.conv_last.1"
    hit = re.fullmatch(r"(ppm_conv|fpn_in|fpn_out)_(\d+)", rest[0])
    if hit:
        inner = ".0" if hit.group(1) == "fpn_out" else ""   # Sequential(ConvBN)
        return (f"dec_model.{hit.group(1)}.{hit.group(2)}{inner}."
                f"{_CONV_BN[rest[1]]}")
    if rest[0] in ("ppm_last_conv", "conv_last"):
        inner = ".0" if rest[0] == "conv_last" else ""      # conv_last.0 is a ConvBN
        return f"dec_model.{rest[0]}{inner}.{_CONV_BN[rest[1]]}"
    raise KeyError(f"no torch name for flax module {path}")


def _bridge(params, batch_stats, module_prefix) -> dict[str, torch.Tensor]:
    sd: dict[str, torch.Tensor] = {}
    bn_modules = []
    for tree in (params, batch_stats):
        for path, v in _walk(tree):
            prefix = module_prefix(path[:-1])
            leaf = path[-1]
            if leaf == "kernel":
                v = np.transpose(v, (3, 2, 0, 1))       # HWIO -> OIHW
            elif leaf == "scale":
                bn_modules.append(prefix)
            sd[f"{prefix}.{_LEAF[leaf]}"] = torch.from_numpy(np.array(v, order="C"))
    for prefix in bn_modules:
        sd[f"{prefix}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def bridge_ocrnet(params, batch_stats) -> dict[str, torch.Tensor]:
    """flax OCRNet params/batch_stats -> the port's OCRNet state dict."""
    return _bridge(params, batch_stats, _ocrnet_prefix)


def bridge_hrnet(params, batch_stats) -> dict[str, torch.Tensor]:
    """flax HRNetv2 params/batch_stats -> the port's HRNetv2 state dict."""
    return _bridge(params, batch_stats, _hrnet_prefix)


def bridge_deeplabv3(params, batch_stats) -> dict[str, torch.Tensor]:
    """flax DeepLabv3 params/batch_stats -> the port's state dict."""
    return _bridge(params, batch_stats, lambda p: _deeplab_prefix(p, False))


def bridge_deeplabv3plus(params, batch_stats) -> dict[str, torch.Tensor]:
    """flax DeepLabv3+ params/batch_stats -> the port's state dict."""
    return _bridge(params, batch_stats, lambda p: _deeplab_prefix(p, True))


def bridge_encdec_upernet(params, batch_stats) -> dict[str, torch.Tensor]:
    """flax EncDec (ResNet encoder + UPerNet decoder) params/batch_stats ->
    the port's state dict."""
    return _bridge(params, batch_stats, _encdec_upernet_prefix)
