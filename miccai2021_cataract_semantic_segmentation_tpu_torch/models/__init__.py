"""Model construction from a reference-style `graph` config section."""
from __future__ import annotations

import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.deeplab import (  # noqa: F401
    DeepLabv3, DeepLabv3Plus)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.discriminator import (  # noqa: F401
    SimpleDiscriminator)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.encdec import EncDec  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ensemble import (  # noqa: F401
    Ensemble, build_ensemble, ensemble_apply, normalise_imagenet)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.fcn_unet import FCN, UNet  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.hrnet import HRNetv2  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.inception import (  # noqa: F401
    InceptionV3Encoder)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.ocr import OCRNet  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.pointrend import (  # noqa: F401
    PointRendDecoder)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.projector import Projector  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import (  # noqa: F401
    ResNetBackbone, output_channels)
from miccai2021_cataract_semantic_segmentation_tpu_torch.models.upernet import UPerNetDecoder  # noqa: F401


def _construct(name: str, graph: dict, task: int) -> torch.nn.Module:
    if name == "OCRNet":
        return OCRNet(task=task, backbone=graph.get("backbone", "resnet101"),
                      out_stride=graph.get("out_stride", 8),
                      dropout=graph.get("dropout", 0.0),
                      projector=graph.get("projector"))
    if name in ("DeepLabv3", "DeepLabv3Plus"):
        cls = DeepLabv3 if name == "DeepLabv3" else DeepLabv3Plus
        return cls(task=task, backbone=graph.get("backbone", "resnet50"),
                   out_stride=graph.get("out_stride", 16),
                   c_aspp=graph.get("aspp", {}).get("channels", 256),
                   projector=graph.get("projector"))
    if name == "EncDec":
        return EncDec(task, graph.get("encoder"), graph.get("decoder"),
                      graph.get("projector"))
    if name in ("UPerNet", "PointRend"):   # shorthands: EncDec with that decoder
        return EncDec(task, graph.get("encoder", {"model": "ResNet50"}),
                      {"model": name, **graph.get("decoder", {})},
                      graph.get("projector"))
    if name == "HRNetv2":
        return HRNetv2(task=task, width=graph.get("width", 32))
    if name == "FCN":
        return FCN(task=task, width=graph.get("width", 1.0))
    if name == "UNet":
        return UNet(task=task)
    if name == "SimpleDiscriminator":
        return SimpleDiscriminator(d=graph.get("d", 64),
                                   input_hw=graph.get("input_hw", (544, 960)))
    raise ValueError(f"Unknown model '{name}'")


def build_model(graph: dict, task: int, device: str | torch.device = "cuda",
                seed: int = 0) -> torch.nn.Module:
    """The graph's model in eval mode on `device`, with weights initialised
    from `seed` (the caller's global RNG state is left as it was). The
    Ensemble is built from its members' checkpoints (`build_ensemble`)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = _construct(graph.get("model", "OCRNet"), graph, task)
    return model.to(dev).eval()
