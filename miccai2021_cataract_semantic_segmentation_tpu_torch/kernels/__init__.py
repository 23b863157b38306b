"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (the CPU path and the kernel's oracle on the card).

`KERNELS` maps each kernel's name to its wrapper; every wrapper has a
`launches` count, a `name`, and `replaces` (the Pallas kernel it ports).
P1/P2's wrappers stay in their module, `kernels.fused_upsample`, which a
wrapper of the same name would otherwise shadow on this package.
"""
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_grad import (  # noqa: F401
    bucket_dlogits, bucket_dlogits_plain, bucket_gather, bucket_gather_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (  # noqa: F401
    bucket_histogram, bucket_histogram_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import fused_upsample as _p12
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import (  # noqa: F401
    fu_grad, fu_grad_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (  # noqa: F401
    fu_histogram, fu_histogram_plain)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_grad import (  # noqa: F401
    nchw1_gradient, nchw_grad_plain, nchw_gradient)
from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (  # noqa: F401
    nchw1_histogram, nchw_histogram, nchw_histogram_plain)

# B1, B2, B3, B4, B4f, B5, B6, B7, B8, P1, P2
KERNELS = {k.name: k for k in (fu_histogram, fu_grad, bucket_histogram,
                               bucket_gather, bucket_dlogits, nchw_histogram,
                               nchw_gradient, nchw1_histogram, nchw1_gradient,
                               _p12.fused_upsample, _p12.fused_downsample)}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}
