"""PyTorch/CUDA port of the CaDIS segmentation framework.

The JAX package `miccai2021_cataract_semantic_segmentation_tpu` is the
reference; this package mirrors its layout (taxonomy, ops/, models/,
losses/, train/, data/) and adds `kernels/`, whose CUDA sources under
`kernels/csrc/` replace the reference's Pallas TPU kernels. It imports
torch and numpy only — never jax, flax, optax or the JAX package.

Entry points take a `device` that defaults to "cuda" and raise when CUDA is
absent unless the caller passes device="cpu" (the CPU runs every kernel's
plain PyTorch version).
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The entry points' device rule: CUDA unless the caller asks for the
    CPU; a CUDA request on a machine without CUDA raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run "
                           "the port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device '{device}'")
    return dev
