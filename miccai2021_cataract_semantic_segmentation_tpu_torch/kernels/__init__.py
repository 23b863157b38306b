"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (the CPU path and the kernel's oracle on the card).

`KERNELS` maps each kernel's name to its wrapper; every wrapper has a
`launches` count, a `name`, and `replaces` (the Pallas kernel it ports).
"""
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import (  # noqa: F401
    fu_grad, fu_grad_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (  # noqa: F401
    fu_histogram, fu_histogram_plain)

KERNELS = {k.name: k for k in (fu_histogram, fu_grad)}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0
