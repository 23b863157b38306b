"""Model construction from a reference-style `graph` config section."""
from __future__ import annotations

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.deeplab import (  # noqa: F401
    DeepLabv3, DeepLabv3Plus)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.encdec import EncDec  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.hrnet import HRNetv2  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import OCRNet  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import (  # noqa: F401
    ResNetBackbone, output_channels)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.upernet import UPerNetDecoder  # noqa: F401

_PORTED = ("OCRNet", "HRNetv2", "DeepLabv3", "DeepLabv3Plus", "EncDec", "UPerNet")


def _construct(name: str, graph: dict, task: int) -> torch.nn.Module:
    if name == "HRNetv2":
        return HRNetv2(task=task, width=graph.get("width", 32))
    if name == "OCRNet":
        return OCRNet(task=task, backbone=graph.get("backbone", "resnet101"),
                      out_stride=graph.get("out_stride", 8),
                      dropout=graph.get("dropout", 0.0))
    if name == "EncDec":
        return EncDec(task, graph.get("encoder"), graph.get("decoder"),
                      graph.get("projector"))
    if name == "UPerNet":       # shorthand: EncDec with a UPerNet decoder
        return EncDec(task, graph.get("encoder", {"model": "ResNet50"}),
                      {"model": "UPerNet", **graph.get("decoder", {})},
                      graph.get("projector"))
    cls = DeepLabv3 if name == "DeepLabv3" else DeepLabv3Plus
    return cls(task=task, backbone=graph.get("backbone", "resnet50"),
               out_stride=graph.get("out_stride", 16),
               c_aspp=graph.get("aspp", {}).get("channels", 256))


def build_model(graph: dict, task: int, device: str | torch.device = "cuda",
                seed: int = 0) -> torch.nn.Module:
    """The graph's model in eval mode on `device`, with weights initialised
    from `seed` (the caller's global RNG state is left as it was)."""
    dev = resolve_device(device)
    name = graph.get("model", "OCRNet")
    if name not in _PORTED:
        raise NotImplementedError(f"graph '{name}' is not ported yet (ROADMAP "
                                  "Queue A item 12: the remaining graphs)")
    if name != "HRNetv2" and (graph.get("backbone", "").startswith("hrnetv2")
                              or graph.get("projector") is not None):
        raise NotImplementedError(
            f"{name} on HRNet and the projector branch are not ported yet "
            "(ROADMAP Queue A item 12)")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = _construct(name, graph, task)
    return model.to(dev).eval()
