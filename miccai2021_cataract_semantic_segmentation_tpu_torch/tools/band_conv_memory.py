"""What a band's 3x3 convolution costs on the card by how its height is
padded: the peak memory and time of one forward and backward, float32,
TF32 off, at the band shapes of phase 28 of chip_smoke.py (a (1, 2) grid
at 544x960).

    python -m miccai2021_cataract_semantic_segmentation_tpu_torch.tools.band_conv_memory

Each shape is the rows a rank fetches (its band and the window's halo),
convolved three ways:

    p0       the height unpadded, the width padded (models/layers.py's
             band path for dilated or strided windows);
    pp_crop  both padded as in one process, the extra rows cropped at each
             end (its path for undilated, unstrided windows);
    wpad     the width padded by `F.pad`, the convolution unpadded.

It prints one JSON line a shape: each layout's peak allocation over the
inputs (MiB) and its time (CUDA events, mean of 3 after a warm-up). It
runs on the card only.
"""
from __future__ import annotations

import json

import torch
import torch.nn.functional as F

# name: (N, C_in, C_out, rows fetched, width, dilation)
SHAPES = {
    "upernet_conv_last": (2, 2048, 512, 70, 240, 1),
    "upernet_fpn_out_s4": (2, 512, 512, 70, 240, 1),
    "upernet_fpn_out_s8": (2, 512, 512, 36, 120, 1),
    "aspp_d12": (2, 2048, 256, 34 + 24, 120, 12),
    "aspp_d36": (2, 2048, 256, 34 + 72, 120, 36),
    "ocrnet_layer4_d4": (8, 512, 512, 34 + 8, 120, 4),
    "ocrnet_layer3_d2": (8, 256, 256, 34 + 4, 120, 2),
    "unet_up1": (2, 192, 64, 274, 960, 1),
    "resnet34_layer1": (2, 64, 64, 70, 240, 1),
}
LAYOUTS = ("p0", "pp_crop", "wpad")


def measure(shape, layout: str, dev: torch.device) -> dict:
    n, c_in, c_out, rows, width, d = shape
    gen = torch.Generator(device=dev).manual_seed(0)
    w = torch.randn(c_out, c_in, 3, 3, device=dev, generator=gen, requires_grad=True)
    x = torch.randn(n, c_in, rows, width, device=dev, generator=gen, requires_grad=True)

    def f():
        if layout == "p0":
            return F.conv2d(x, w, None, 1, (0, d), d)
        if layout == "pp_crop":
            return F.conv2d(x, w, None, 1, (d, d), d)[:, :, d:rows - d]
        return F.conv2d(F.pad(x, (d, d)), w, None, 1, 0, d)

    g = torch.randn(f().shape, device=dev, generator=gen)
    f().backward(g)                                   # warm-up
    x.grad = w.grad = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    f().backward(g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    x.grad = w.grad = None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        f().backward(g)
        x.grad = w.grad = None
    end.record()
    torch.cuda.synchronize()
    return {"MiB": peak / 2**20, "ms": start.elapsed_time(end) / 3}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("band_conv_memory measures the card; CUDA is not available")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
                      "cudnn": torch.backends.cudnn.version()}), flush=True)
    for name, shape in SHAPES.items():
        print(json.dumps({"shape": name, **{k: measure(shape, k, dev) for k in LAYOUTS}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
