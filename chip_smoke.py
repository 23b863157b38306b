#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases (any failure raises and the run exits non-zero):
  1. the device, its power limit, the torch/CUDA versions, the TF32 flags;
  2. builds every hand-written kernel from the sources in the checkout;
  3. kernel B1 (the fused two-scale bucket-Lovász histogram) against its
     plain PyTorch version on the card, at the flagship shape and at edge
     shapes, with its time, the plain version's time and its bound;
  4. the flagship validation (OCRNet-R50 os8, task 2, 540x960 frames padded
     to 544x960, batch 8, two-scale bucket Lovász at B=1024, bf16) through
     `validate` at full width on a seeded synthetic set, with B1's launch
     count read around that run, one batch's loss recomputed with B1's
     plain version, and the step's device time by kernel group
     (torch.profiler);
  5. the eval-loss step on the card against the same step on the CPU at a
     small input in float32.
The last line of stdout is {"ok": true, "device": {...}}; the line before
it is the card's name and power limit as nvidia-smi reports them.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "OCRNet_rf_lvsz.json")
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12      # H100 SXM float32 outside the tensor cores
# float32 operations B1 does per counted (pixel, class row) pair: 9 for the
# 2x2 interpolation, 5 for the softmax (max, subtract, exp, sum, divide), 2
# for e = |fg - p|; the bucket id and the count are integer work
B1_OPS_PER_PAIR = 16


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median milliseconds of `fn` on the current stream (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def blocky_labels(rng, n, h, w, n_values, block):
    """(n, h, w) int labels in [0, n_values) constant on block x block tiles."""
    grid = rng.integers(0, n_values, (n, -(-h // block), -(-w // block)))
    return np.repeat(np.repeat(grid, block, 1), block, 2)[:, :h, :w]


# ---------------------------------------------------------------------------
# phase 3: B1 against its plain version
# ---------------------------------------------------------------------------

B1_CASES = [
    # name, N, C, s8 (hs, ws), out (H, W), B, edges, dither seed, ignore class
    ("flagship", 8, 17, (68, 120), (544, 960), 1024, "uniform", None, None),
    ("c5", 2, 5, (17, 30), (136, 240), 1024, "uniform", None, None),
    ("odd_hw", 2, 17, (9, 16), (67, 125), 1024, "uniform", None, None),
    ("all_ignore_image", 2, 17, (17, 30), (136, 240), 1024, "uniform", None, 17),
    ("classes_to_ignore", 2, 17, (17, 30), (136, 240), 1024, "uniform", None, 3),
    ("adaptive", 2, 17, (34, 60), (272, 480), 1024, "adaptive", None, None),
    ("dither7", 2, 17, (34, 60), (272, 480), 1024, "uniform", 7, None),
    ("b256", 2, 17, (34, 60), (272, 480), 256, "uniform", None, None),
    ("b2048", 2, 17, (34, 60), (272, 480), 2048, "uniform", None, None),
    ("c25_b2048", 2, 25, (17, 30), (136, 240), 2048, "uniform", None, None),
]


def b1_inputs(case, dev):
    name, n, c, (hs, ws), (h, w), *_, ignore = case
    rng = np.random.default_rng(sum(map(ord, name)))
    li = torch.as_tensor(3.0 * rng.standard_normal((n, c, hs, ws)),
                         dtype=torch.float32, device=dev)
    lf = torch.as_tensor(3.0 * rng.standard_normal((n, c, hs, ws)),
                         dtype=torch.float32, device=dev)
    lbl = blocky_labels(rng, n, h, w, c + 1, 8)
    if name == "all_ignore_image":
        lbl[0] = ignore
    return li, lf, torch.as_tensor(lbl, dtype=torch.int64, device=dev)


def check_b1(dev) -> dict:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
        fu_histogram, fu_histogram_plain, fu_mats)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        fused_two_scale_bucket_lovasz_s8, norm_dither_seed, pad_labels)

    flagship = None
    for case in B1_CASES:
        name, n, c, (hs, ws), (h, w), nb, edges, dseed, ignore = case
        li, lf, labels = b1_inputs(case, dev)
        lbl = pad_labels(labels, ignore)
        mats = fu_mats(hs, ws, (h, w), lbl.shape[1], lbl.shape[2], True, dev)
        ls = torch.cat([li, lf], 1).contiguous()
        seed, dither = norm_dither_seed(dseed)
        kw = dict(n_cls=c, n_buckets=nb, edges=edges, seed=seed, dither=dither)
        got = fu_histogram(ls, lbl, mats, **kw)
        ref = fu_histogram_plain(ls, lbl, mats, **kw)
        torch.cuda.synchronize()
        pairs = 2 * c * int((lbl >= 0).sum())
        rows_equal = bool((got.sum((1, 2)) == ref.sum((1, 2))).all())
        diff = (got.long() - ref.long()).abs()
        l1, max_abs = int(diff.sum()), int(diff.max())
        loss_args = (li, lf, labels, 0.4, 1.0, ignore, nb, edges, dseed)
        loss_k = float(fused_two_scale_bucket_lovasz_s8(
            *loss_args, histogram=fu_histogram))
        loss_p = float(fused_two_scale_bucket_lovasz_s8(
            *loss_args, histogram=fu_histogram_plain))
        print(f"B1 {name}: N={n} C={c} s8={hs}x{ws} out={h}x{w} B={nb} "
              f"edges={edges} dither={dseed} ignore={ignore} pairs={pairs} "
              f"row_totals_equal={rows_equal} hist_l1={l1} "
              f"hist_max_abs={max_abs} loss_kernel={loss_k!r} "
              f"loss_plain={loss_p!r}", flush=True)
        if not rows_equal:
            raise AssertionError(f"B1 {name}: per-row totals differ")
        if l1 > 1e-4 * max(pairs, 1):
            raise AssertionError(f"B1 {name}: histogram L1 {l1} > 1e-4 of "
                                 f"{pairs} counted pairs")
        if not (np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5):
            raise AssertionError(f"B1 {name}: loss {loss_k} vs plain {loss_p}")
        if name == "flagship":
            flagship = dict(ls=ls, lbl=lbl, mats=mats, kw=kw, pairs=pairs,
                            max_abs=max_abs, out_numel=got.numel())

    f = flagship
    kernel_ms = cuda_ms(lambda: fu_histogram(f["ls"], f["lbl"], f["mats"],
                                             **f["kw"]))
    plain_ms = cuda_ms(lambda: fu_histogram_plain(f["ls"], f["lbl"],
                                                  f["mats"], **f["kw"]))
    n_bytes = 4 * (f["ls"].numel() + f["lbl"].numel() + f["out_numel"])
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = B1_OPS_PER_PAIR * f["pairs"] / PEAK_F32_OPS_S * 1e3
    print(f"B1 flagship timing: kernel {kernel_ms!r} ms, plain {plain_ms!r} "
          f"ms (CUDA events, median of 20); bound: {n_bytes} bytes -> "
          f"{t_bytes!r} ms, {B1_OPS_PER_PAIR * f['pairs']} f32 ops -> "
          f"{t_ops!r} ms", flush=True)
    return {"name": fu_histogram.name, "route": "cuda",
            "source": fu_histogram.source, "replaces": fu_histogram.replaces,
            "launches": None, "max_abs_err": f["max_abs"], "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# ---------------------------------------------------------------------------
# phase 4: the flagship validation at full width
# ---------------------------------------------------------------------------

def synthetic_set(n=29, h=540, w=960, seed=0):
    """Seeded task-2 frames: blocky labels in 0..17 and images whose colour
    follows the label, plus noise."""
    rng = np.random.default_rng(seed)
    labels = blocky_labels(rng, n, h, w, 18, 60).astype(np.uint8)
    palette = rng.integers(0, 256, (18, 3))
    noise = rng.integers(-20, 21, (n, h, w, 3))
    images = np.clip(palette[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels


def run_slice(dev, cfg) -> int:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, fu_histogram, fu_histogram_plain, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        fused_two_scale_bucket_lovasz_s8)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import pad_reflect_hw
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_preprocess, eval_spec, make_eval_loss_step)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import validate

    task = int(cfg["data"]["experiment"])
    bs, precision = 8, cfg.get("precision", "bf16")
    images, labels = synthetic_set()
    model = build_model(cfg["graph"], task, device=dev, seed=0)
    spec = eval_spec(cfg["data"]["transforms"])
    step = make_eval_loss_step(build_loss(cfg["loss"], task, dev), spec, dev,
                               precision)
    step(model, images[:bs], labels[:bs], 0)      # warm-up: cuDNN, the build
    torch.cuda.synchronize()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = validate(model, cfg, images, labels, device=dev, batch_size=bs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: k.launches for name, k in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    n_full = len(images) // bs

    step_ms = cuda_ms(lambda: step(model, images[:bs], labels[:bs], 0),
                      reps=10, warmup=1)
    profile_step(lambda: step(model, images[:bs], labels[:bs], 0))
    cm = res["confusion_matrix"]
    lbl_pad = pad_reflect_hw(torch.as_tensor(labels))
    expected = int((lbl_pad < 17).sum())
    print("validate:", json.dumps({k: res[k] for k in (
        "valid_loss", "miou", "miou_instruments", "miou_anatomies",
        "miou_rare", "pa", "pac")}), flush=True)
    print(f"validate: {len(images)} frames, {n_full} full batches of {bs} + "
          f"tail of {len(images) - n_full * bs}; {seconds!r} s wall; "
          f"eval-loss step {step_ms!r} ms (CUDA events, median of 10) = "
          f"{bs / step_ms * 1e3!r} frames/s; peak memory {peak} bytes; "
          f"B1 launches {launches}; cm total {int(cm.sum())} of {expected} "
          f"counted pixels", flush=True)
    if launches[fu_histogram.name] != n_full:
        raise AssertionError(f"B1 launched {launches[fu_histogram.name]} "
                             f"times in validate, expected {n_full}")
    for key in ("valid_loss", "miou", "pa", "pac"):
        if not np.isfinite(res[key]):
            raise AssertionError(f"validate {key} = {res[key]}")
    if int(cm.sum()) != expected:
        raise AssertionError(f"confusion matrix holds {int(cm.sum())} pixels, "
                             f"expected {expected}")

    # one full batch's loss, kernel against plain, from the same s8 logits
    lcfg = cfg["loss"]
    with torch.inference_mode():
        x, lbl = eval_preprocess(torch.as_tensor(images[:bs]).to(dev), spec,
                                 torch.as_tensor(labels[:bs]).to(dev))
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = model(x, full_res_interm=False)
        args = (out["interm_logits_s8"], out["logits_s8"], lbl,
                lcfg["interm"]["weight"], lcfg["final"]["weight"], None,
                int(lcfg["lovasz_buckets"]))
        loss_k = float(fused_two_scale_bucket_lovasz_s8(
            *args, histogram=fu_histogram))
        loss_p = float(fused_two_scale_bucket_lovasz_s8(
            *args, histogram=fu_histogram_plain))
    print(f"batch 0 loss: kernel {loss_k!r}, plain {loss_p!r}", flush=True)
    if abs(loss_k - loss_p) > 1e-5:
        raise AssertionError(f"batch loss kernel {loss_k} vs plain {loss_p}")
    return launches[fu_histogram.name]


# (B1's launches inside the profiled steps come after its count was read)
_GROUPS = (("B1 fu_hist", ("fu_hist",)),
           ("copies", ("memcpy", "memset")),
           ("layout NCHW<->NHWC", ("nchwtonhwc", "nhwctonchw")),
           ("convolution", ("conv", "cudnn", "xmma", "implicit", "fprop",
                            "winograd", "nhwc")),
           ("matmul", ("gemm", "cutlass", "gemv", "nvjet")),
           ("batch norm", ("batch_norm", "bn_fw", "batchnorm")),
           ("reduction/softmax/argmax", ("reduce", "softmax", "argmax",
                                         "max_", "cumsum", "scan")),
           ("bincount/index", ("bincount", "histogram", "index", "gather",
                               "scatter")),
           ("elementwise", ("elementwise", "vectorized", "unrolled", "cat",
                            "copy", "fill")))


def kernel_group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def profile_step(run_step, steps: int = 3) -> None:
    """Device time by kernel group over `steps` eval-loss steps
    (torch.profiler), against their CUDA-event span."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            run_step()
        end.record()
        end.synchronize()
    span_ms = start.elapsed_time(end)
    groups, top = {}, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        groups[kernel_group(ev.key)] = groups.get(kernel_group(ev.key), 0.0) + us
        top.append((us, ev.count, ev.key))
    busy_ms = sum(groups.values()) / 1e3
    print(f"profile: {steps} eval-loss steps, span {span_ms!r} ms (CUDA "
          f"events), device kernel time {busy_ms!r} ms = busy share "
          f"{busy_ms / span_ms!r}", flush=True)
    print("profile groups (ms per step): " + json.dumps(
        {g: us / 1e3 / steps for g, us in sorted(
            groups.items(), key=lambda kv: -kv[1])}), flush=True)
    for us, count, key in sorted(top, reverse=True)[:12]:
        print(f"profile top: {us / 1e3 / steps!r} ms/step, {count // steps} "
              f"launches/step, {key[:110]}", flush=True)


# ---------------------------------------------------------------------------
# phase 5: card against CPU at a small input, float32
# ---------------------------------------------------------------------------

def card_vs_cpu(dev, cfg) -> None:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_spec, make_eval_loss_step)

    task = int(cfg["data"]["experiment"])
    images, labels = synthetic_set(n=2, h=64, w=96, seed=1)
    spec = eval_spec(cfg["data"]["transforms"])
    outs = {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for d in (dev, torch.device("cpu")):
            model = build_model(cfg["graph"], task, device=d, seed=0)
            step = make_eval_loss_step(build_loss(cfg["loss"], task, d), spec,
                                       d, "fp32")
            logits, _, cm, loss = step(model, images, labels, 0)
            outs[d.type] = (logits.cpu(), cm.cpu(), float(loss))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    (lg_g, cm_g, loss_g), (lg_c, cm_c, loss_c) = outs["cuda"], outs["cpu"]
    rel = float((lg_g - lg_c).abs().max() / lg_c.abs().max())
    cm_l1 = int((cm_g - cm_c).abs().sum())
    n_pix = int(cm_c.sum())
    print(f"card vs CPU (2x64x96, fp32): logits max rel err {rel!r}, loss "
          f"{loss_g!r} vs {loss_c!r}, confusion-matrix L1 {cm_l1} of "
          f"{n_pix} pixels", flush=True)
    if rel > 1e-4 or abs(loss_g - loss_c) > 1e-4 or cm_l1 > 2e-3 * n_pix:
        raise AssertionError("the card's eval-loss step disagrees with the CPU's")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import build
    except ImportError as exc:
        print(f"chip_smoke: the port's package is not beside this script "
              f"({exc})", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    t0 = time.perf_counter()
    built = build.build()
    print(f"kernels built in {time.perf_counter() - t0!r} s: {built}",
          flush=True)

    with open(CONFIG) as f:
        cfg = json.load(f)
    b1 = check_b1(dev)
    b1["launches"] = run_slice(dev, cfg)
    card_vs_cpu(dev, cfg)

    print("kernel B1 fu_hist: ported (CUDA C++, sm_90a)")
    print(json.dumps({"kernels": [b1]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
