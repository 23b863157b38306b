"""The transform vocabulary: the device augmentation and the pipeline.

Port of `DeviceAugmentSpec`, `TransformPipeline` and
`build_transform_pipeline` from the JAX package's data/transforms.py. The
host stage (the affine and crop transforms, applied per sample before a
batch reaches the card) is not ported yet (ROADMAP Queue A item 7, the
host transforms); a config that lists one raises here.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# names of the host-side geometric transforms not ported yet
HOST_TRANSFORMS = ("rot", "shift", "shear", "affine", "crop")


@dataclass(frozen=True)
class DeviceAugmentSpec:
    """What the on-device augmentation (ops/augment.py) does."""
    pad: bool = False
    flip: bool = False
    blur: bool = False
    colorjitter: bool = False
    pseudo_colorjitter_strength: int | None = None
    normalise: bool = False


def device_spec(transforms) -> DeviceAugmentSpec:
    """The train-time device spec of a config's `data.transforms` list, as
    the JAX package parses it (the reference's utils/utils.py:332-450
    vocabulary; names it does not know are ignored)."""
    names = [t for t in transforms if isinstance(t, str)]
    host = [t for t in names if t in HOST_TRANSFORMS]
    if host:
        raise NotImplementedError(
            f"host transforms {host} are not ported yet (ROADMAP Queue A "
            "item 7: the host transforms)")
    strength = None
    if "pseudo_colorjitter" in names:
        strength = 2
        for e in transforms:
            if isinstance(e, dict) and "strength" in e:
                strength = e["strength"]
    return DeviceAugmentSpec(
        pad="pad" in names,
        flip="flip" in names,
        blur="blur" in names,
        colorjitter="colorjitter" in names,
        pseudo_colorjitter_strength=strength,
        normalise="torchvision_normalise" in names)


@dataclass
class TransformPipeline:
    """The train-time device spec, and whether validation pads (`"pad"`
    listed). The host stage is empty: no host transform is ported."""
    device: DeviceAugmentSpec = field(default_factory=DeviceAugmentSpec)
    valid_pad: bool = False


def build_transform_pipeline(transform_list, transform_values: dict,
                             task: int) -> TransformPipeline:
    """The pipeline of a config's `data.transforms` (`transform_values`
    and `task` configure the host transforms, which raise)."""
    names = [t for t in transform_list if isinstance(t, str)]
    return TransformPipeline(device=device_spec(transform_list),
                             valid_pad="pad" in names)
