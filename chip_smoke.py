#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (one NVIDIA GPU).

    python3 chip_smoke.py

Phases (any failure raises and the run exits non-zero):
  1. the device, its power limit, the torch/CUDA versions, the TF32 flags;
  2. builds every hand-written kernel from the sources in the checkout;
  3. kernel B1 (the fused bucket-Lovász histogram) against its plain
     PyTorch version on the card, at the flagship shape (two scales,
     align_corners=True), at the UPerNet cell's (one stride-4 scale,
     136x240 -> 544x960, align_corners=False), at the DeepLabv3 cell's
     (one scale, align_corners=True, B 2048), at edge shapes of both
     conventions and at the flagship's shape with peaked logits, as from a
     net that has learnt (B1_CASES): per-row totals equal, histogram L1
     <= 1e-4 of the counted pairs, loss within 1e-5, two runs bit-equal;
     with the share of counted pairs in the two hottest bins of each half,
     its time, the plain version's time and its bound at the flagship,
     UPerNet, peaked and DeepLabv3 rows (B1_TIMED);
  4. kernel B2 (the fused bucket-Lovász backward) against its plain
     version at the same shapes and conventions, from the bf16-rounded,
     cotangent-scaled table of a forward on the same inputs: its bucket ids
     counted must give B1's histogram exactly, its gradient must equal the
     plain arithmetic at those ids, and two runs must agree bit for bit;
     with its time, the plain version's time, its bound and, at the timed
     rows, the kernel alone (profiler) as a share of its call;
  5. the flagship validation (OCRNet-R50 os8, task 2, 540x960 frames padded
     to 544x960, batch 8, two-scale bucket Lovász at B=1024, bf16) through
     `validate` at full width on a seeded synthetic set, with B1's launch
     count read around that run, one batch's loss recomputed with B1's
     plain version, and the step's device time by kernel group
     (torch.profiler);
  6. the eval-loss step on the card against the same step on the CPU at a
     small input in float32;
  7. the flagship train slice at full width (the same model, set and
     precision; pad, flip, blur and colorjitter; Adam at 1e-4) through
     `train_steps` over the set's full batches, with B1's and B2's launch
     counts read around that run (one each per step), then a 10-step
     overfit of one batch whose loss must fall; the train step's time,
     frames/s, peak memory and device time by kernel group;
  8. the train step on the card against the same step on the CPU at a
     small input (TF32 off, pad only), for two batches: in float64 loss,
     gradients, grad_norm, new parameters, BatchNorm statistics and the s8
     confusion matrix to tight tolerances; in float32 the same, with the
     gradients held by their distance from the float64 ones;
  9. kernel B3 (the generic bucket-Lovász histogram) against its plain
     version at the HRNetv2 cell's shape (17 rows of 8 x 544 x 960 pixels)
     and at edge shapes (one row, an odd row length, 136 per-image rows,
     all errors 0, all exactly 1, errors piled in buckets 0 and 2047, every
     bucket edge and its float32 neighbours, `classes_to_ignore` pixels,
     the cell's shape from the logits of an untrained net, views whose
     errors and flags start at other alignments, errors above 1):
     the int32 counts and int64 fixed-point sums equal, the float32
     histograms bit-equal, the error sums within one float32
     rounding of a float64 sum (plus 2^-48 per pixel in bucket 0), the
     per-class losses equal and within 1e-5 of a float64 evaluation, two
     runs bit-equal; with the time, the plain version's, the bound and the
     pairs in each of the four hot bins (buckets 0 and 2047 of both
     halves) at the cell, piled and untrained-net cases (B3_TIMED);
 10. kernel B4 (the generic backward gather) against its plain version at
     the same shapes, from the bf16-rounded table of a forward on the same
     inputs: bit-equal, two runs bit-equal; with its time, the kernel
     alone and its bound; 10b. kernel B4f (the generic route's fused
     backward to d loss / d logits) at the cases built from logits (the
     cell, its per-image form, `classes_to_ignore`, the untrained net;
     B4F_CASES) in float32 and bf16 against its plain version (float32:
     relative L2 <= 1e-6, largest difference <= 1e-5 of the largest
     element; bf16: within one bf16 ulp of every element) and in float32
     against the parent commit's composition (autograd through
     `lovasz_rows` into B4; relative L2 <= 1e-5), two runs bit-equal; its
     times at the cell, and the loss backward of one HRNetv2 step on the
     parent's composition and on the new route in turns, with their peak
     memory;
 11. the HRNetv2-W32 cell at full width: configs/DeepLabv3_rf_lvsz.json with
     the graph {"model": "HRNetv2", "width": 32} and the loss
     {"name": "LovaszSoftmax", "lovasz_impl": "bucket"} (task 2, 540x960
     frames padded to 544x960, batch 8, bf16, pad/flip/blur/colorjitter,
     Adam at 1e-4) on the same synthetic set: `validate` and `train_steps`
     with the launch counts read around each (one B3 per eval-loss batch
     and per train step, one B4f per train step, none of B4 or B1/B2), one
     batch's loss recomputed with B3's plain version, a 10-step overfit of
     one batch (pad only) whose loss falls at every step, the train step's
     time, frames/s, peak memory and device time by kernel group; 11b.
     `train_steps` of one batch on the parent's composition and on the new
     route in turns, their peak memory;
 12. the HRNetv2 train step on the card against the CPU as phase 8 does it
     for OCRNet, at width 8 (a reduction of width for the CPU's sake), with
     the pairs whose bucket differs between the two sides counted (see
     MOVED_TOL);
 13. kernels B5/B7 (the v3 route's forward histogram on full-resolution
     grids, two scales or one) and B6/B8 (its backward) against their plain
     versions at the flagship's and the DeepLabv3 cell's grids and at edge
     shapes (NCHW_CASES): row totals equal, histogram L1 <= 1e-3 of the
     counted pairs, the backward's ids reproduce the forward's counts
     exactly, gradients equal to the plain arithmetic at those ids within
     float32 rounding, two runs bit-equal, dither under v3 refused; with
     their times, the plain versions' and their bounds, each kernel alone
     (profiler) as a share of its call and the hottest bins' shares, at
     the flagship's grids, the DeepLabv3 cell's and the flagship's from
     peaked logits (NCHW_TIMED);
 14. the DeepLabv3-R50 os8 cell at full width: configs/DeepLabv3_rf_lvsz.json
     with its loss replaced by {"name": "LovaszSoftmax", "lovasz_impl":
     "bucket"}, otherwise as phase 11 runs HRNetv2 (one B1 per eval-loss
     batch and per train step, one B2 per step, one batch's loss against
     B1's plain version, the overfit, the step's time and profile); then
     one `validate` of DeepLabv3+, whose B1 reads a stride-4 source;
 15. the v3 route (`_USE_V3` set around the calls): `train_steps` of the
     DeepLabv3 cell (one B7 and one B8 per step) and of the OCRNet flagship
     (one B5 and one B6), one batch's loss and pre-upsample gradient
     against v4, and each step's time on both routes, in turns, with their
     profiles;
 16. the DeepLabv3 train step on the card against the CPU, as phase 8;
 17. kernels P1/P2 (the prototype fused upsample of stacked logit rows and
     its transpose) against float64 evaluations of the same products at
     P_CASES (the prototype's shape, align_corners=False matrices, C = 17,
     an odd source and output, one image, a ragged case with no size a
     multiple of a tile and rows not 16-byte aligned): relative L2 <= 1e-6,
     P1 within 1e-4 of `upsample_nchw`, P2's two runs bit-equal (P1's
     recorded); their times, the plain versions', the library calls', the
     GFLOP their tiles issue, and a bound that counts the contraction
     three times at the dense TF32 rate (3xTF32) beside the float32 one;
     then the prototype counterpart's `main` on the card, whose P1/P2
     launches the record reports;
 18. the EncDec-UPerNet-R34 cell at full width: configs/UPN_rf_lvsz.json
     (task 2, 540x960 frames padded to 544x960, batch 8, bf16,
     pad/flip/blur/colorjitter, Adam at 1e-4, random weights from seed 0)
     with its LossWrapper sent to the fused route ({"losses":
     {"LovaszSoftmax": 1}, "lovasz_impl": "bucket"}), as phase 14 runs
     DeepLabv3: one B1 (R = 17, B 2048, align_corners=False from the
     stride-4 `logits_s8_acf`) per eval-loss batch and per train step, one
     B2 per step, none of the others; one batch's loss against B1's plain
     version, the overfit, the step's time and profile;
 19. the UPerNet train step on the card against the CPU, as phase 8, its
     float32 gradients held as F32_LOSS_GRAD_TOL says;
 20. the served path from PNGs on disk: the synthetic set written as a
     CaDIS tree (tools/synthetic_tree.py: the port's PNG encoder, every
     filter type, canonical label ids, data.csv) under split 2's test
     videos beside frames of training videos that inference leaves out;
     configs/OCRNet_pretrained_t{1,2,3}.json through the port's CLI, one
     process each, from a seed-0 OCRNet-R50 saved in the reference's
     `<run>/chkpts/chkpt_best.pt` layout (only data_path, log_path and
     load_checkpoint changed): every class pixel counted, t2's confusion
     matrix equal to `validate`'s on the arrays; `infer`'s frames/s at
     valid batch 1 and 8 (and at 8 with 8 reader threads), and its parts
     at both (without the triptych images, also from memory, the eval
     step alone); the flagship's `Trainer.validate(0)` (the config
     in inference mode, so its validation set is those test videos) with
     one B1 a full batch and none of the others, its loss and matrix equal
     to `validate`'s on the same frames and weights; the decoder that ran
     and each decoder's ms per frame, and the numpy and C++ PNG unfilters'
     ms on one frame;
 21. the flagship recipe trained through the port's CLI from PNGs on disk:
     configs/OCRNet_rf_lvsz.json (only data_path, log_path, run_id,
     train.epochs 3, log_every_n_epochs 1 and profile_epoch 1 changed) on
     a synthetic CaDIS tree of 24 training frames, of which 9 hold a rare
     class each (r(I) 1.897 at threshold 0.15, so the epochs run 3 or 4
     batches), and 8 validation frames. Run A in process through `main`,
     its launches counted: one B1 a train step and a full validation
     batch, one B2 a train step, none of the others; its ind_dist.npz
     equal to a host replay of the repeat-factor sampler (seed + 1), its
     `last` checkpoint holding the optimiser and the step, its epoch-1
     trace naming B1 and B2. A repeat of A (the card's run-to-run spread of
     the final weights). Run B stopped at epoch 2's validation and resumed
     from `last` by the CLI in a subprocess: its step, index counts and
     batches equal to A's, its final weights within twice the spread of
     A's (bit-equal where the spread is 0). Prints each epoch's ms/step
     (StepTimer), frames/s and the decode's share, each run's wall time
     and A's peak memory;
 22. on a tree of phase 21's frames plus 8 frames of split 2's test videos
     (which training leaves out): (a) the flagship recipe with the
     projector ({"d": 256, "mlp": [[1, 512, 1]], "use_bn": true}), the
     LossWrapper {TwoScaleLoss: 1, DenseContrastiveLoss: 0.1,
     DenseContrastiveLossV2: 0.1} at dc_off_at_epoch 1 and the affine host
     warp, 2 epochs through the CLI in process: one B1 a step and a
     validation batch, one B2 a step, none of the others; the V1 term
     non-zero at every step of epoch 0 and 0 in epoch 1, V2 non-zero;
     (b) configs/DeepLabv3Plus_rf_lvsz.json with ["crop", "flip",
     "colorjitter", "torchvision_normalise"] and the LossWrapper
     {OhemCrossEntropy, FocalLoss, GenDiceLoss, SoftIoU, LovaszSoftmax
     (bucket)}, 2 epochs: the 192x192 crops reach every step, the same
     launch gates; (c) each new loss on the card in float32 against the CPU
     in float64 at the flagship's full-resolution shape (value within 1e-5,
     gradient relative L2 within 1e-4), `sliding_miou` card against CPU,
     and the host warp's and crop's ms a frame;
 23. on the same tree, the flagship with SemiSupervisedLoss {labeled: its
     TwoScaleLoss (bucket Lovász), pseudo_threshold: 0.9} through
     `Trainer.train` for 2 epochs, the left-out frames as the unlabelled
     pool: two B3 (one a half) and four B4f (one a scale a half) a step,
     one B1 a validation batch, none of the others; B3 and B4f against
     their plain versions at the half-batch shape (histogram bit-equal,
     gradients as phase 10b); the batches [labelled | unlabelled] and the
     index counts labelled only; a run stopped after epoch 0 and resumed
     from `last`, bit-equal to the uninterrupted one (within twice a
     repeat's spread where that is not 0); one step's pseudo-labels equal
     to an explicit teacher pass, which leaves BatchNorm's buffers and the
     train mode as they were; the semi step's and the flagship step's
     times in turns and the teacher's share; a run initialised from a
     synthetic MoCo-v2 checkpoint;
 24. the remaining graphs, on the same tree: (a) EncDec-PointRend-R50
     (the flagship recipe with the UPerNet cell's LossWrapper, bucket
     Lovász) trained 2 epochs through the CLI: PointRend gives no stride-8
     logits, so one B3 a train step and a validation batch and one B4f a
     step, none of the others; `point_loss` finite in every step's
     scalars; two subdivision steps a validation forward; the subdivision
     on the card (float32 with TF32 off) against the CPU at one 272x480
     frame (the coarse map, the cells each step selects, under a bound
     stated below, and the refined values where both select), then in
     bf16 (its end-to-end share of differing cells printed, each step
     replayed on the CPU from the card's input to it: the cells selected
     and the values written); the
     PointRend and UPerNet-R50 train and eval steps timed in turns, the
     PointRend step profiled; (b) OCRNet-R18/R34 and on HRNet-W18 (the
     flagship recipe: B1/B2 from stride-32 and stride-4 logits), FCN and
     UNet (the LossWrapper's generic route: B3/B4f, UNet at 18 channels),
     EncDec-UPerNet on Inception-v3, ResNeXt-50 and WideResNet-50 (the
     UPerNet cell: B1/B2, the Inception's from a 132x236 grid), each
     through `validate` of one batch of 8 and `train_steps` of two at full
     width with its launches counted, its train step timed and its narrow
     forward (2x128x160) on the card in float32 against the CPU in float64;
     B3 and B4f at UNet's C 18 against their plain versions; the
     SimpleDiscriminator's forward and backward; (c) the Ensemble of an
     OCRNet-R50 and a UPerNet-R34, each saved as chkpt_best.pt after one
     step, through the CLI in inference mode with mean and with max merge,
     its matrix and mIoU equal to the functional `ensemble_apply` on the
     same batches;
 25. the served extras, on the same tree: (a) OCRNet-R50 t2
     (configs/OCRNet_pretrained_t2.json, a seed-0 checkpoint) through the
     CLI with `"tta": true` at valid batch 8 (flip x scales 0.75-2.0), its
     matrix equal to the in-process `infer(tta=True)`'s, no kernel
     launched, frames/s and peak memory; the TTA step and the eval step
     alone on a batch already on the card (CUDA events) and one TTA step
     profiled: the device's rate and busy share; the TTA probabilities on
     the card (float32, TF32 off) against the CPU (float64) at one 136x240
     frame within 1e-4; (b) two 540x960 videos of 13 and 11 frames written by
     the port's AVI writer under workflow/test/, through both video modes
     of the CLI with `demo_frame_freq` 1 and 2 and decode workers 1 and 4,
     each output read back by the port's reader equal to the colormap of
     the in-process eval step's argmax over the same batches, the codec,
     frames/s, no kernel launched; (c) `export_trainer` of that model, of
     its TTA variant and of an Ensemble (it and a UPerNet-R34), each `.pt2`
     loaded in a process that blocks the port package and served at batch
     1 and 8: the class of at most 1e-3 of the pixels and the confidence
     within 5e-3 of the Trainer's steps at the same precision (bf16), the
     export s, the serve ms (median and quartiles of 20 calls at batch 1
     and 10 at batch 8, after 2 warm-up calls) and, at batch 1, the
     device's busy ms and operations a call (profiler); (d) the flagship with SemiSupervisedLoss
     and no given pool: the pool is two training-split videos in the
     port's AVI under their release names (train_1/train01.mp4,
     train_1/train03.mp4), `Trainer.train` for one epoch, the pool's length
     (the labelled frames left out), and one B3 a half and one B4f a scale
     a half each step, one B1 a validation batch;
 26. training and serving over several ranks: (a) the flagship through
     the CLI under torchrun as one NCCL rank, its index batches, step
     losses, final weights and validation metrics against the plain run's
     (bit-equal), and the flagship step timed with no group and with the
     rank's data group in turns; (b) two gloo ranks on cuda:0 (NCCL
     refuses two ranks on one card): gloo's all-reduces of CUDA tensors
     (the differentiable one with its gradient), then the flagship step at
     544x960 on a global batch of 8 in bf16, one B1 and one B2 a rank, its
     summed confusion matrix against the same step in one process on the
     same 8 frames and draws (the label counts equal, at most
     PAR_CM_SHARE of the pixels counted in another class) and each rank's
     own loss against the loss of its half of the one-process logits
     (within PAR_LOSS_TOL), then the 2-rank float64 step of phase 8's input
     on the card against the same step on two CPU ranks (F64_TOL); (c) the
     serving export over [cuda:0, cuda:0] at batch 8 bit-equal, shard by
     shard, to the one-device artifact; (d) the times of (a) and (b);
 27. the offline tools, the reproduction harness and the twins: (a) the
     sort and the bucket twin of tools/trajectory_twins.py (port package)
     at full width (OCRNet-R50 os8, task 2, learnable 540x960 frames padded
     to 544x960, batch 8, bf16, B 1024, pool 32, Adam at 1e-4, data seed 0,
     20 steps a twin): one B1 and one B2 each bucket step and no kernel on
     a sort step, every loss finite, the first-step losses within 1e-3;
     both trajectories, the tail gap, rel_param_distance, each twin's ms a
     step and the peak memory; (b) tools/reproduce_paper.py (port package)
     on phase 20's tree with seed-0 OCRNet-R50 .pt files for t1-t3 in the
     reference's layout: exit 1 (random weights miss the paper's band),
     each task's mIoU that of `Trainer.infer` on the same config and
     frames, no kernel launched; (c) tools/build_frame_table.py over that
     tree, its paths and class counts equal to the tree's data.csv,
     class_distribution and split_quality on the result, add_blacklist
     round-tripping it;
 28. the spatial grid (parallel/spatial.py): the JAX dry run's 2-D mesh as
     a (1, 2) grid of two gloo ranks on cuda:0, each holding 272 of the
     544 padded rows of every activation of OCRNet-R50 at output stride 8,
     on the flagship's loss and augmentation at 544x960, global batch 8:
     (a) its float32 step (TF32 off) against the same step in one process
     on the same frames, weights and draws, held to GRID28_RATIO times
     what 1e-7 of weight noise moves the one-process step (grad_norm, the
     BatchNorm statistics, the share of Adam updates that change sign),
     the loss within 1e-5; each rank's step time and the time inside
     gloo's all-reduces; (b) one bf16 step, its loss difference and the
     matrix's share of moved pixels printed; (c) the eval step of the
     one-process step's weights, its classes against one process's, held
     the same way; (d) rank 0 alone writes the checkpoint, both ranks
     restore it bit-equal; (e) one B1 and one B2 a rank in the step; (f)
     a rank's peak memory at most GRID28_MEMORY_SHARE of one process's;
     (g) the other graphs the grid splits, float32 against one process at
     batch GRID28_GRAPH_BATCH: the HRNetv2-W32 and DeepLabv3-R50 os8 train
     steps held as (a) and (f) (one B3 and one B4f, one B1 and one B2 a
     rank), the eval-loss steps of OCRNet on HRNet-W18 and DeepLabv3+-R50
     (one B1 a rank) held as (c) and in their loss, each graph's step ms
     and seconds inside gloo printed; (h) the decoders the grid splits,
     the same way at GRID28_GRAPH_BATCH on configs/UPN_rf_lvsz.json's
     LossWrapper bucket Lovász: the UPerNet-R34, FCN (width 1.0) and UNet
     train steps (one B1 and one B2 a rank; one B3 and one B4f a rank, at
     C 17 and 18) and the UPerNet-ResNeXt-50 eval-loss step (one B1 a
     rank).
Each phase prints its wall time. The line before the last line of stdout
is the card's name and power limit as nvidia-smi reports them; the line
before it is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "OCRNet_rf_lvsz.json")
# the HRNetv2 cell: this recipe with its graph and loss replaced
HR_CONFIG = os.path.join(ROOT, "configs", "DeepLabv3_rf_lvsz.json")
HR_LOSS = {"name": "LovaszSoftmax", "lovasz_impl": "bucket"}
# the UPerNet cell: this recipe with its LossWrapper on the fused route
UPN_CONFIG = os.path.join(ROOT, "configs", "UPN_rf_lvsz.json")
UPN_LOSS = {"losses": {"LovaszSoftmax": 1}, "lovasz_impl": "bucket"}
PEAK_BYTES_S = 3.35e12      # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12      # H100 SXM float32 outside the tensor cores
PEAK_TF32_OPS_S = 495e12    # H100 SXM dense TF32 on the tensor cores
# float32 operations B1 does per counted (pixel, class row) pair: 9 for the
# 2x2 interpolation, 5 for the softmax (max, subtract, exp, sum, divide), 2
# for e = |fg - p|; the bucket id and the count are integer work
B1_OPS_PER_PAIR = 16
# B2 per counted pair: B1's 16, 1 for the sign of the gathered de (the
# gather is a load), 4 for the softmax VJP (dp * p, its sum, dp - s, times
# p) and 4 for the width pass of the separable transposed interpolation
# (two taps, a multiply and an add each); the height pass does 4 per
# element of the (N, R, H_pad, ws) width-transposed rows, which is
# 4 * ws / W_pad per pair (`b2_ops`)
B2_OPS_PER_PAIR = 16 + 1 + 4 + 4
B2_OPS_PER_HEIGHT_TAP_PAIR = 4
# B3 per (row, pixel) pair: the bucket id's multiply, the bf16 rounding,
# the fixed-point scale and the sum; B4: the bucket id's multiply (the
# gather is a load)
B3_OPS_PER_PAIR = 4
B4_OPS_PER_PAIR = 1
# B4f per (pixel, class row) pair: the bucket id's multiply, 5 for the
# softmax (max, subtract, exp, sum, divide), 1 for the sign of the gathered
# dE and 4 for the softmax VJP (dp * p, its sum, dp - s, times p)
B4F_OPS_PER_PAIR = 1 + 5 + 1 + 4


def b2_ops(pairs: int, ws: int, w_pad: int) -> float:
    """The float32 operations B2's function needs for `pairs` counted
    (pixel, row) pairs on a W_pad-wide grid read from ws source columns."""
    return pairs * (B2_OPS_PER_PAIR + B2_OPS_PER_HEIGHT_TAP_PAIR * ws / w_pad)


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


def _record(kernel, max_abs, ms, plain_ms, n_bytes, ops, what: str,
            peak_ops_s: float = PEAK_F32_OPS_S, ops_unit: str = "f32") -> dict:
    """A kernel's line of the `kernels` record (launches filled in later),
    with its bound from the bytes and operations of the timed inputs (at
    `peak_ops_s`, float32 outside the tensor cores unless given); prints
    the timing."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops_s * 1e3
    print(f"{what} timing: kernel {ms!r} ms, plain {plain_ms!r} ms (CUDA "
          f"events, median of 20; plain of 5 from B3 on); bound: {n_bytes} "
          f"bytes -> {t_bytes!r} ms, {ops!r} {ops_unit} ops -> {t_ops!r} ms",
          flush=True)
    return {"name": kernel.name, "route": "cuda", "source": kernel.source,
            "replaces": kernel.replaces, "launches": None, "max_abs_err": max_abs,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3: B1 against its plain version
# ---------------------------------------------------------------------------

B1_CASES = [
    # name, N, C, s8 (hs, ws), out (H, W), B, edges, dither seed, ignore
    # class, align_corners: True runs both scales (the TwoScaleLoss route),
    # False one (the LossWrapper's single-scale route from `logits_s8_acf`)
    ("flagship", 8, 17, (68, 120), (544, 960), 1024, "uniform", None, None, True),
    ("c5", 2, 5, (17, 30), (136, 240), 1024, "uniform", None, None, True),
    ("odd_hw", 2, 17, (9, 16), (67, 125), 1024, "uniform", None, None, True),
    ("all_ignore_image", 2, 17, (17, 30), (136, 240), 1024, "uniform", None, 17, True),
    ("classes_to_ignore", 2, 17, (17, 30), (136, 240), 1024, "uniform", None, 3, True),
    ("adaptive", 2, 17, (34, 60), (272, 480), 1024, "adaptive", None, None, True),
    ("dither7", 2, 17, (34, 60), (272, 480), 1024, "uniform", 7, None, True),
    ("b256", 2, 17, (34, 60), (272, 480), 256, "uniform", None, None, True),
    ("b2048", 2, 17, (34, 60), (272, 480), 2048, "uniform", None, None, True),
    ("c25_b2048", 2, 25, (17, 30), (136, 240), 2048, "uniform", None, None, True),
    # B1's rows shared by a cluster of two blocks (C > 28 at B 2048)
    ("c32_b2048", 2, 32, (17, 30), (136, 240), 2048, "uniform", None, None, True),
    # the UPerNet cell's stride-4 source, and an odd acf edge case
    ("upernet_acf", 8, 17, (136, 240), (544, 960), 2048, "uniform", None, None, False),
    ("acf_odd_ignore3", 2, 17, (9, 16), (67, 125), 1024, "uniform", None, 3, False),
    # the flagship's shape with the logits of a net that has learnt (see
    # b1_inputs): most pairs land in bucket 0 of their half
    ("peaked", 8, 17, (68, 120), (544, 960), 1024, "uniform", None, None, True),
    # the DeepLabv3 cell's single-scale route: align_corners=True, one scale
    # (B1_ONE_SCALE), B 2048 (B2's table is 139 KB in bf16)
    ("deeplabv3", 8, 17, (68, 120), (544, 960), 2048, "uniform", None, None, True),
    # phase 22(b)'s DeepLabv3+ on the single-scale route: its stride-4
    # logits of a 192x192 crop in each train step, and of an unpadded frame
    # in its validation (the eval pad is off where crop is listed)
    ("deeplabv3plus_crop", 8, 17, (48, 48), (192, 192), 2048, "uniform", None, None, True),
    ("deeplabv3plus_valid", 8, 17, (135, 240), (540, 960), 2048, "uniform", None, None,
     True),
    # phase 24's graphs on the fused routes: OCRNet-R18/34's stride-32
    # logits and OCR-on-HRNet's stride-4 ones (the flagship's TwoScaleLoss,
    # two scales at B 1024), and the Inception-UPerNet's odd stride-4 grid
    # (132x236 at 544x960; the LossWrapper's single scale, align_corners=False)
    ("ocrnet_r18", 8, 17, (17, 30), (544, 960), 1024, "uniform", None, None, True),
    ("ocr_hrnet", 8, 17, (136, 240), (544, 960), 1024, "uniform", None, None, True),
    ("inception_acf", 8, 17, (132, 236), (544, 960), 2048, "uniform", None, None, False),
]
# the align_corners=True rows that run one scale (the single-scale route)
B1_ONE_SCALE = ("deeplabv3", "deeplabv3plus_crop", "deeplabv3plus_valid")


def b1_scales(case):
    """The logits of a B1_CASES row: both scales, or the first alone for an
    align_corners=False row and the rows of B1_ONE_SCALE."""
    return 2 if case[-1] and case[0] not in B1_ONE_SCALE else 1


def b1_inputs(case, dev):
    name, n, c, (hs, ws), (h, w), *_, ignore, _align = case
    rng = np.random.default_rng(sum(map(ord, name)))
    li = torch.as_tensor(3.0 * rng.standard_normal((n, c, hs, ws)),
                         dtype=torch.float32, device=dev)
    lf = torch.as_tensor(3.0 * rng.standard_normal((n, c, hs, ws)),
                         dtype=torch.float32, device=dev)
    lbl = blocky_labels(rng, n, h, w, c + 1, 8)
    if name == "all_ignore_image":
        lbl[0] = ignore
    if name == "peaked":
        # std 3 plus 15 on the class of the label under each s8 cell (the
        # label at (8i, 8j)); a label of C raises no class
        under = torch.as_tensor(lbl[:, ::8, ::8][:, :hs, :ws], device=dev)
        raise_ = 15.0 * (under[:, None] == torch.arange(c, device=dev)[:, None, None])
        li, lf = li + raise_, lf + raise_
    return li, lf, torch.as_tensor(lbl, dtype=torch.int64, device=dev)


# the rows whose times phases 3-4 print; the flagship's go into the record
B1_TIMED = ("flagship", "upernet_acf", "peaked", "deeplabv3")


def hot_bin_shares(counts: torch.Tensor) -> dict:
    """The share of counted pairs in the two hottest bins of each half
    (bg, fg) of an int32 (R, 2, B) histogram."""
    total = max(int(counts.sum()), 1)
    out = {}
    for half, name in enumerate(("bg", "fg")):
        top = counts[:, half].sum(0).topk(2)
        out[name] = {int(i): float(v) / total for v, i in zip(*top)}
    return out


def check_b1(dev) -> dict:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
        fu_histogram, fu_histogram_plain, fu_mats)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        fused_bucket_lovasz_s8, fused_two_scale_bucket_lovasz_s8, norm_dither_seed,
        pad_labels)

    timed = {}
    for case in B1_CASES:
        name, n, c, (hs, ws), (h, w), nb, edges, dseed, ignore, align = case
        li, lf, labels = b1_inputs(case, dev)
        lbl = pad_labels(labels, ignore)
        mats = fu_mats(hs, ws, (h, w), lbl.shape[1], lbl.shape[2], align, dev)
        scales = b1_scales(case)
        ls = torch.cat([li, lf][:scales], 1).contiguous()
        seed, dither = norm_dither_seed(dseed)
        kw = dict(n_cls=c, n_buckets=nb, edges=edges, seed=seed, dither=dither)
        got = fu_histogram(ls, lbl, mats, **kw)
        again = fu_histogram(ls, lbl, mats, **kw)
        ref = fu_histogram_plain(ls, lbl, mats, **kw)
        torch.cuda.synchronize()
        deterministic = bool(torch.equal(got, again))
        pairs = scales * c * int((lbl >= 0).sum())
        rows_equal = bool((got.sum((1, 2)) == ref.sum((1, 2))).all())
        diff = (got.long() - ref.long()).abs()
        l1, max_abs = int(diff.sum()), int(diff.max())
        if scales == 2:
            loss_fn, loss_args = fused_two_scale_bucket_lovasz_s8, (
                li, lf, labels, 0.4, 1.0, ignore, nb, edges, dseed)
        else:
            loss_fn, loss_args = fused_bucket_lovasz_s8, (
                li, labels, None, ignore, nb, align, edges, dseed)
        loss_k = float(loss_fn(*loss_args, histogram=fu_histogram))
        loss_p = float(loss_fn(*loss_args, histogram=fu_histogram_plain))
        print(f"B1 {name}: N={n} C={c} s8={hs}x{ws} out={h}x{w} B={nb} "
              f"align_corners={align} scales={scales} "
              f"edges={edges} dither={dseed} ignore={ignore} pairs={pairs} "
              f"row_totals_equal={rows_equal} hist_l1={l1} "
              f"hist_max_abs={max_abs} two_runs_bit_equal={deterministic} "
              f"loss_kernel={loss_k!r} loss_plain={loss_p!r}", flush=True)
        if not deterministic:
            raise AssertionError(f"B1 {name}: two runs differ")
        if not rows_equal:
            raise AssertionError(f"B1 {name}: per-row totals differ")
        if l1 > 1e-4 * max(pairs, 1):
            raise AssertionError(f"B1 {name}: histogram L1 {l1} > 1e-4 of "
                                 f"{pairs} counted pairs")
        if not (np.isfinite(loss_k) and abs(loss_k - loss_p) <= 1e-5):
            raise AssertionError(f"B1 {name}: loss {loss_k} vs plain {loss_p}")
        if name in B1_TIMED:
            print(f"B1 {name}: share of counted pairs in the two hottest bins "
                  f"of each half {json.dumps(hot_bin_shares(got))}", flush=True)
            timed[name] = dict(ls=ls, lbl=lbl, mats=mats, kw=kw, pairs=pairs,
                               max_abs=max_abs, out_numel=got.numel())

    records = {}
    for name, f in timed.items():
        kernel_ms = cuda_ms(lambda: fu_histogram(f["ls"], f["lbl"], f["mats"],
                                                 **f["kw"]))
        plain_ms = cuda_ms(lambda: fu_histogram_plain(f["ls"], f["lbl"],
                                                      f["mats"], **f["kw"]))
        n_bytes = 4 * (f["ls"].numel() + f["lbl"].numel() + f["out_numel"])
        records[name] = _record(fu_histogram, f["max_abs"], kernel_ms, plain_ms,
                                n_bytes, B1_OPS_PER_PAIR * f["pairs"], f"B1 {name}")
    return records["flagship"]


# ---------------------------------------------------------------------------
# phase 4: B2 against its plain version
# ---------------------------------------------------------------------------

def check_b2(dev) -> dict:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import (
        fu_grad, fu_grad_plain, grad_from_fields)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
        fu_histogram, fu_mats, plain_fields)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        fu_core_fwd, grad_table, losses_and_tables, norm_dither_seed, pad_labels)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import fu_grad_ablation

    timed = {}
    for case in B1_CASES:
        name, n, c, (hs, ws), (h, w), nb, edges, dseed, ignore, align = case
        li, lf, labels = b1_inputs(case, dev)
        lbl = pad_labels(labels, ignore)
        mats = fu_mats(hs, ws, (h, w), lbl.shape[1], lbl.shape[2], align, dev)
        scales = b1_scales(case)
        parts = [li, lf][:scales]
        ls = torch.cat(parts, 1).contiguous()
        seed, dither = norm_dither_seed(dseed)
        kw = dict(n_cls=c, n_buckets=nb, edges=edges, seed=seed, dither=dither)
        # the table of the loss 0.4 * interm + 1.0 * final (one scale: 1.0
        # * the loss): per row, the scale's weight over the number of
        # classes present in it
        _, gts, g_fg, g_bg = losses_and_tables(fu_core_fwd(
            parts, lbl, c, (h, w), nb, align, edges, seed, dither))
        present = (gts > 0).float().reshape(scales, c)
        weights = torch.tensor([[0.4], [1.0]][2 - scales:], device=dev)
        ct = (weights * present
              / present.sum(1, keepdim=True).clamp_min(1.0)).reshape(-1)
        table = grad_table(g_fg, g_bg, ct)
        got, bids = fu_grad.with_bucket_ids(ls, lbl, mats, table, **kw)
        again = fu_grad(ls, lbl, mats, table, **kw)
        ref = fu_grad_plain(ls, lbl, mats, table, **kw)
        p, fg, keep, pbid = plain_fields(ls, lbl, mats, **kw)
        kbid = bids.reshape(pbid.shape).long()
        same_ids = grad_from_fields(p, fg, keep, kbid, mats, table)
        torch.cuda.synchronize()
        counted = keep[:, None, None].expand_as(pbid)
        pairs = int(counted.sum())
        id_diff = int((counted & (kbid != pbid)).sum())
        row = torch.arange(scales * c, device=dev).reshape(1, scales, c, 1, 1)
        key = (row * 2 + fg[:, None].long()) * nb + kbid
        b2_hist = torch.bincount(key[counted], minlength=scales * c * 2 * nb)
        b1_hist = fu_histogram(ls, lbl, mats, **kw)
        hist_equal = bool(torch.equal(b2_hist.int().reshape(b1_hist.shape), b1_hist))
        deterministic = bool(torch.equal(got, again))
        rel = float((got - ref).norm() / ref.norm())
        max_abs = float((got - ref).abs().max())
        rel_same = float((got - same_ids).norm() / same_ids.norm())
        print(f"B2 {name}: N={n} C={c} s8={hs}x{ws} out={h}x{w} B={nb} "
              f"align_corners={align} scales={scales} "
              f"edges={edges} dither={dseed} ignore={ignore} pairs={pairs} "
              f"rel_l2_vs_plain={rel!r} max_abs_vs_plain={max_abs!r} "
              f"bucket_ids_differing_from_plain={id_diff} "
              f"rel_l2_vs_plain_at_kernel_ids={rel_same!r} "
              f"ids_reproduce_B1_histogram={hist_equal} "
              f"two_runs_bit_equal={deterministic}", flush=True)
        if not hist_equal:
            raise AssertionError(f"B2 {name}: its bucket ids do not reproduce "
                                 "B1's histogram")
        if not deterministic:
            raise AssertionError(f"B2 {name}: two runs differ")
        if not rel_same <= 1e-5:
            raise AssertionError(f"B2 {name}: relative L2 {rel_same} > 1e-5 "
                                 "against the plain arithmetic at its ids")
        if id_diff > 1e-4 * max(pairs, 1):
            raise AssertionError(f"B2 {name}: {id_diff} bucket ids differ from "
                                 f"the plain version's, > 1e-4 of {pairs}")
        if name in B1_TIMED:
            timed[name] = dict(ls=ls, lbl=lbl, mats=mats, table=table, kw=kw,
                               pairs=pairs, max_abs=max_abs, out_numel=got.numel())

    records = {}
    for name, f in timed.items():
        args = (f["ls"], f["lbl"], f["mats"], f["table"])
        kernel_ms = cuda_ms(lambda: fu_grad(*args, **f["kw"]))
        plain_ms = cuda_ms(lambda: fu_grad_plain(*args, **f["kw"]))
        n_bytes = 4 * (f["ls"].numel() + f["lbl"].numel() + f["table"].numel()
                       + f["out_numel"])
        ops = b2_ops(f["pairs"], f["ls"].shape[3], f["lbl"].shape[2])
        records[name] = _record(fu_grad, f["max_abs"], kernel_ms, plain_ms,
                                n_bytes, ops, f"B2 {name}")
        device_ms = fu_grad_ablation.device_ms(lambda: fu_grad(*args, **f["kw"]))
        print(f"B2 {name}: the kernel alone {device_ms!r} ms (profiler, median "
              f"of 20), {device_ms / kernel_ms!r} of the call's {kernel_ms!r} ms",
              flush=True)
    return records["flagship"]


# ---------------------------------------------------------------------------
# phase 5: the flagship validation at full width
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


def run_slice(dev, cfg) -> None:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, fu_histogram, fu_histogram_plain, launch_counts, reset_launches)
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
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_full = len(images) // bs

    step_ms = cuda_ms(lambda: step(model, images[:bs], labels[:bs], 0),
                      reps=10, warmup=1)
    profile_step(lambda: step(model, images[:bs], labels[:bs], 0), "eval-loss")
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
          f"kernel launches {launches}; cm total {int(cm.sum())} of {expected} "
          f"counted pixels", flush=True)
    if launches != dict(dict.fromkeys(KERNELS, 0), fu_hist=n_full):
        raise AssertionError(f"kernel launches in validate {launches}, "
                             f"expected {n_full} of B1 and none of B2")
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
            out = model(x, full_res=("logits",))
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


# (the kernels' launches inside the profiled steps come after their counts
# were read)
_GROUPS = (("P1/P2 fused_upsample", ("fused_upsample",)),
           ("B1 fu_hist", ("fu_hist",)),
           ("B2 fu_grad", ("fu_grad",)),
           ("B3 bucket_hist", ("bucket_hist",)),
           ("B4 bucket_grad", ("bucket_gather",)),
           ("B4f bucket_dlogits", ("bucket_dlogits",)),
           ("B5/B7 nchw_hist", ("nchw_hist",)),
           ("B6/B8 nchw_grad", ("nchw_grad",)),
           ("copies", ("memcpy", "memset")),
           ("layout NCHW<->NHWC", ("nchwtonhwc", "nhwctonchw")),
           ("optimizer (Adam)", ("adam", "multi_tensor", "foreach")),
           ("convolution", ("conv", "cudnn", "xmma", "implicit", "fprop",
                            "dgrad", "wgrad", "winograd", "nhwc")),
           ("matmul", ("gemm", "cutlass", "gemv", "nvjet")),
           ("batch norm", ("batch_norm", "bn_fw", "bn_bw", "batchnorm")),
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


def profile_step(run_step, what: str, steps: int = 3) -> dict:
    """Device time by kernel group over `steps` `what` steps
    (torch.profiler), against their CUDA-event span; returns ms per step
    by group."""
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
        # a record_function range such as `Optimizer.step#Adam.step` shows
        # as a device span too; it is not kernel time
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False) or "#" in ev.key):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        groups[kernel_group(ev.key)] = groups.get(kernel_group(ev.key), 0.0) + us
        top.append((us, ev.count, ev.key))
    busy_ms = sum(groups.values()) / 1e3
    per_step = {g: us / 1e3 / steps for g, us in sorted(
        groups.items(), key=lambda kv: -kv[1])}
    print(f"profile: {steps} {what} steps, span {span_ms!r} ms (CUDA "
          f"events), device kernel time {busy_ms!r} ms = busy share "
          f"{busy_ms / span_ms!r}", flush=True)
    print(f"profile groups, {what} (ms per step): " + json.dumps(per_step),
          flush=True)
    for us, count, key in sorted(top, reverse=True)[:12]:
        print(f"profile top, {what}: {us / 1e3 / steps!r} ms/step, "
              f"{count // steps} launches/step, {key[:110]}", flush=True)
    return per_step


# ---------------------------------------------------------------------------
# phase 6: card against CPU at a small input, float32
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


# ---------------------------------------------------------------------------
# phase 7: the flagship train slice at full width
# ---------------------------------------------------------------------------

def run_train_slice(dev, cfg) -> dict:
    """`train_steps` over the synthetic set's full batches with the kernels'
    counts read around it, a 10-step overfit of one batch, the train step's
    time and its device time by kernel group; returns the launch counts of
    the first run and the profile."""
    import copy

    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
        train_metrics_source, train_steps)

    task, bs = int(cfg["data"]["experiment"]), 8
    images, labels = synthetic_set()
    model = build_model(cfg["graph"], task, device=dev, seed=0)
    n_full = len(images) // bs
    batches = list(np.arange(n_full * bs).reshape(n_full, bs))
    # warm-up on a copy: cuDNN's plans, the allocator
    train_steps(copy.deepcopy(model), cfg, images, labels, batches[:1],
                device=dev)
    torch.cuda.synchronize()

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train_steps(model, cfg, images, labels, batches, device=dev)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print("train_steps: " + json.dumps({k: res[k] for k in (
        "loss", "miou", "pa", "step_losses", "seconds", "frames_per_s")})
          + f"; {n_full} steps of {bs} frames; peak memory {peak} bytes; "
          f"kernel launches {launches}; cm total "
          f"{int(res['confusion_matrix'].sum())}", flush=True)
    if launches != dict(dict.fromkeys(KERNELS, 0), fu_hist=n_full, fu_grad=n_full):
        raise AssertionError(f"kernel launches in train_steps {launches}, "
                             f"expected one B1 and one B2 per step ({n_full})")
    if not np.isfinite(res["step_losses"]).all():
        raise AssertionError(f"train losses {res['step_losses']}")

    reset_launches()
    fit = train_steps(model, cfg, images, labels, [batches[0]] * 10,
                      device=dev, seed=1)
    fit_launches = launch_counts()
    losses = fit["step_losses"]
    print(f"overfit, 10 steps on one batch: losses {losses}; kernel "
          f"launches {fit_launches}", flush=True)
    if fit_launches != dict(dict.fromkeys(KERNELS, 0), fu_hist=10, fu_grad=10):
        raise AssertionError(f"kernel launches in the overfit {fit_launches}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the overfit loss does not fall: {losses}")

    state = fit["state"]
    step = make_train_step(build_loss(cfg["loss"], task, dev),
                           device_spec(cfg["data"]["transforms"]), task,
                           device=dev, precision=cfg.get("precision", "bf16"),
                           train_metrics=train_metrics_source(cfg))
    imgs, lbls = images[:bs], labels[:bs]
    step_ms = cuda_ms(lambda: step(state, imgs, lbls, 0), reps=10, warmup=2)
    print(f"train step: {step_ms!r} ms (CUDA events, median of 10) = "
          f"{bs / step_ms * 1e3!r} frames/s", flush=True)
    groups = profile_step(lambda: step(state, imgs, lbls, 0), "train")
    total = sum(groups.values())
    print(f"train step shares: B1 {groups.get('B1 fu_hist', 0.0) / total!r}, "
          f"B2 {groups.get('B2 fu_grad', 0.0) / total!r} of the device "
          "kernel time", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 8: the train step on the card against the CPU, float64 and float32
# ---------------------------------------------------------------------------

# float64 card against float64 CPU, from the same weights and batch, just
# above the largest of the readings of two sound runs on an H100 (PERF.md,
# PR 2). The loss runs in float32 on both sides, as it casts its inputs, so
# the loss may differ by an ulp and the gradients by B2's float32 arithmetic
# against its plain version (about 5e-8); "params" is the largest new
# parameter difference over lr, set by the two convolution biases that feed
# a BatchNorm, whose gradient is rounding noise that Adam's first update
# scales up to a fraction of lr
F64_TOL = {"loss": 2.5e-7, "grads": 1e-7, "grad_norm": 5e-8, "stats": 1e-12,
           "params": 3e-2}
# float32: the card's gradients may be at most this many times as far from
# the CPU's float64 ones as the CPU's float32 gradients are (read: 0.78
# and 0.98)
F32_GRAD_RATIO = 1.25
# The generic bucket route reads full-resolution logits through torch's
# float32 softmax, which the card and the CPU may round differently in the
# last bit: an error on a bucket edge then lands in the neighbouring bucket
# on one side and takes that bucket's gradient, a step of its own (one such
# pair moved the float32 gradients by about 7e-4 in an H100 run, PERF.md,
# PR 3). Phase 12 counts the (row, pixel) pairs whose bucket differs
# between the card's and the CPU's loss inputs. Where none moved, the
# float64 step is held to F64_TOL; where some moved, its gradients and
# their norm are held to MOVED_TOL instead, and so are the float32
# gradients when they miss the F32_GRAD_RATIO gate, while the new
# parameters are not held (a gradient element near zero may then change
# sign, and Adam's first step moves it by about lr either way)
MOVED_TOL = 1e-2
# UPerNet (phase 19) at random weights and batch 2: its parameter
# gradients are ill-conditioned. Float64 steps on the CPU from weights
# moved by WEIGHT_NOISE (relative), which moves the loss input two to
# three times as far as float32 arithmetic does, land 0.5-6.4 % from the
# unmoved step. The card's float32 gradients landed 0.7 % and 6.1 % from
# float64, the CPU's 0.5 % and 0.1 % (H100 runs, PERF.md): cuDNN's
# algorithms meeting that conditioning, since with cuDNN off on the card
# the 6.1 % fell to 0.24 %, its largest parts encoder layer1/layer2
# BatchNorm biases. So the card's float32 gradients, with cuDNN and
# without, must lie no further from float64 than the larger of
# F32_GRAD_RATIO times the CPU's float32 gradients and the farthest of
# NOISE_DRAWS such float64 draws; and the gradient of the loss input (B2's
# output, through the float32 forward) must agree with the CPU's within
# F32_LOSS_GRAD_TOL, a hundred times what it was with 239 and 283 pairs in
# another bucket (9.0e-6 and 1.0e-5 in the same runs)
F32_LOSS_GRAD_TOL = 1e-3
WEIGHT_NOISE = 1e-6
NOISE_DRAWS = 3


def flat_grads(model) -> torch.Tensor:
    """Every parameter's gradient in one float64 vector (a float32 norm
    over its 39M elements is off in the third digit on the CPU)."""
    return torch.cat([p.grad.cpu().reshape(-1) for p in model.parameters()]).double()


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest difference over the largest magnitude."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max())


def one_train_step(dev, cfg, images, labels, dtype, noise_seed=None) -> dict:
    """One Lovász train step (pad only, Adam) of the seed-0 model in
    `dtype` on `dev`, its weights first scaled by 1 + WEIGHT_NOISE * a
    normal draw from `noise_seed` when that is given: its loss, grad_norm,
    s8 confusion matrix, gradients and new state dict, on the CPU; with a
    loss that reads the full-resolution logits, also the bucket ids (R, P)
    of its rows; with one that reads `logits_s8_acf` (the fused
    single-scale route), those logits (`s4`, float32), their bucket ids
    (N, 1, C, H_pad, W_pad) and their gradient (`dloss`)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import bucket_ids
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
        fu_mats, plain_fields)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import pad_labels
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import lovasz_rows
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step

    task = int(cfg["data"]["experiment"])
    model = build_model(cfg["graph"], task, device=dev, seed=0).to(dtype)
    if noise_seed is not None:
        gen = torch.Generator().manual_seed(noise_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + WEIGHT_NOISE * torch.randn(p.shape, generator=gen,
                                                      dtype=p.dtype).to(p.device))
    state = create_train_state(model, cfg["train"], make_schedule(cfg["train"], 1))
    loss_fn, seen = build_loss(cfg["loss"], task, dev), {}

    def recording_loss(outputs, lbl, **kwargs):
        if "logits" in outputs:
            seen["rows"] = lovasz_rows(outputs["logits"].detach(), lbl)[0]
        elif "logits_s8_acf" in outputs:
            s4 = outputs["logits_s8_acf"]
            s4.register_hook(lambda g: seen.update(dloss=g.detach().double().cpu()))
            x, lp = s4.detach().float().cpu(), pad_labels(lbl).cpu()
            mats = fu_mats(x.shape[2], x.shape[3], tuple(lbl.shape[1:]), lp.shape[1],
                           lp.shape[2], False, torch.device("cpu"))
            _, _, keep, bid = plain_fields(
                x, lp, mats, n_cls=x.shape[1],
                n_buckets=int(cfg["loss"].get("lovasz_buckets", 2048)))
            seen["fused_bids"] = torch.where(keep[:, None, None], bid, -1)
            seen["s4"] = x
        return loss_fn(outputs, lbl, **kwargs)

    recording_loss.full_res = loss_fn.full_res
    step = make_train_step(recording_loss, device_spec(["pad"]),
                           task, device=dev,
                           precision="fp64" if dtype == torch.float64 else "fp32",
                           train_metrics="s8")
    m = step(state, images, labels, 0)
    bids = bucket_ids(seen["rows"]).cpu() if "rows" in seen else seen.get("fused_bids")
    return dict(loss=float(m["loss"]), norm=float(m["grad_norm"]),
                cm=m["confusion_matrix"].cpu(), grads=flat_grads(model),
                sd={k: v.cpu() for k, v in model.state_dict().items()},
                bids=bids, dloss=seen.get("dloss"), s4=seen.get("s4"))


def train_card_vs_cpu(dev, cfg, what: str = "OCRNet") -> None:
    """The train step of `what` on the card against the same step on the
    CPU at a small input (TF32 off, pad only), for two seeded batches.

    In float64 every output must agree to F64_TOL: the card's path (its
    convolutions and BatchNorm forward and backward, B1 and B2, Adam) is
    the CPU's. In float32 the gradients part by a few percent: float32's own
    rounding, amplified through the train-mode network at random weights
    and batch 2, moves each side's gradients that far from float64. There
    the card's float32 gradients must be no more than F32_GRAD_RATIO times
    as far from the CPU's float64 gradients as the CPU's float32 ones are;
    loss, BatchNorm statistics and the confusion matrix are held as before.
    A loss on full-resolution logits (the generic bucket route) is held as
    MOVED_TOL says where pairs moved buckets between the two sides; one on
    `logits_s8_acf` (UPerNet) as F32_LOSS_GRAD_TOL says (its gradients
    also against float64 draws from moved weights, and once more with
    cuDNN off), with the pairs whose bucket moved counted."""
    lr = float(cfg["train"]["learning_rate"])
    cpu = torch.device("cpu")
    failed = []
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for seed in (1, 2):
            images, labels = synthetic_set(n=2, h=64, w=96, seed=seed)
            runs = {(d.type, dt): one_train_step(d, cfg, images, labels, dt)
                    for d in (dev, cpu) for dt in (torch.float64, torch.float32)}
            for dt in (torch.float64, torch.float32):
                card, host = runs[dev.type, dt], runs["cpu", dt]
                sd_g, sd_c = card["sd"], host["sd"]
                stats = [k for k in sd_c if k.endswith(("running_mean", "running_var"))]
                params = [k for k in sd_c if k not in stats
                          and not k.endswith("num_batches_tracked")]
                got = dict(
                    loss=abs(card["loss"] - host["loss"]),
                    grads=rel_l2(card["grads"], host["grads"]),
                    grad_norm=abs(card["norm"] / host["norm"] - 1),
                    stats=max(rel_l2(sd_g[k], sd_c[k]) for k in stats),
                    params=max(float((sd_g[k] - sd_c[k]).abs().max())
                               for k in params) / lr,
                    cm_l1=int((card["cm"] - host["cm"]).abs().sum()))
                moved = (0 if card["bids"] is None
                         else int((card["bids"] != host["bids"]).sum()))
                tol = dict(F64_TOL, **(dict(grads=MOVED_TOL, grad_norm=MOVED_TOL,
                                            params=float("inf")) if moved else {}))
                print(f"{what} train step card vs CPU ({dt}, batch seed {seed}, "
                      f"2x64x96, TF32 off, pad only): loss {card['loss']!r} vs "
                      f"{host['loss']!r}; grad_norm {card['norm']!r} vs "
                      f"{host['norm']!r}; pairs in another bucket {moved}; "
                      + json.dumps(got), flush=True)
                if dt == torch.float64:
                    bad = {k: v for k, v in got.items()
                           if k != "cm_l1" and v > tol[k]}
                    if bad or got["cm_l1"]:
                        failed.append(f"float64, batch seed {seed}: {got}")
                    continue
                ref = runs["cpu", torch.float64]["grads"]
                err_card = rel_l2(card["grads"], ref)
                err_cpu = rel_l2(host["grads"], ref)
                print(f"{what} train step, float32 gradients against the CPU's float64 "
                      f"(batch seed {seed}): the card's {err_card!r}, the CPU's "
                      f"{err_cpu!r}", flush=True)
                held = (got["loss"] > 1e-5 or got["stats"] > 1e-4
                        or got["cm_l1"] > 2e-3 * int(host["cm"].sum()))
                if card["dloss"] is None:
                    grads_bad = err_card > max(F32_GRAD_RATIO * err_cpu,
                                               MOVED_TOL if moved else 0.0)
                else:
                    s4_ref = runs["cpu", torch.float64]["s4"]
                    draws = []
                    for k in range(1, NOISE_DRAWS + 1):
                        moved_run = one_train_step(cpu, cfg, images, labels,
                                                   torch.float64, noise_seed=k)
                        draws.append((rel_l2(moved_run["grads"], ref),
                                      max_rel(moved_run["s4"], s4_ref)))
                    cudnn = torch.backends.cudnn.enabled
                    torch.backends.cudnn.enabled = False
                    try:
                        no_cudnn = one_train_step(dev, cfg, images, labels, dt)
                    finally:
                        torch.backends.cudnn.enabled = cudnn
                    err_no_cudnn = rel_l2(no_cudnn["grads"], ref)
                    bound = max(F32_GRAD_RATIO * err_cpu, max(g for g, _ in draws))
                    dloss = rel_l2(card["dloss"], host["dloss"])
                    print(f"{what} train step, float32 (batch seed {seed}): the card's "
                          f"loss input {max_rel(card['s4'], s4_ref)!r} (max relative) "
                          f"from float64's, its gradients {err_card!r}, with cuDNN off "
                          f"{err_no_cudnn!r}; float64 steps from weights moved by "
                          f"{WEIGHT_NOISE} (relative) land (gradients, loss input) "
                          f"{draws!r} from the unmoved one; the gradients' gate "
                          f"{bound!r}; the loss input's gradient, card against CPU: "
                          f"relative L2 {dloss!r}", flush=True)
                    grads_bad = (dloss > F32_LOSS_GRAD_TOL or err_card > bound
                                 or err_no_cudnn > bound)
                if held or grads_bad:
                    failed.append(f"float32, batch seed {seed}: {got}, "
                                  f"{err_card} vs {err_cpu} from float64")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if failed:
        raise AssertionError(f"the card's {what} train step disagrees with "
                             "the CPU's: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# phases 9-10: B3 and B4 against their plain versions
# ---------------------------------------------------------------------------

B3_CASES = ("cell", "per_image_136", "r1", "p_odd", "zeros", "ones", "piled",
            "edges", "classes_to_ignore", "init", "misaligned", "above_one")
# the cases whose times phase 9 prints; the cell's goes into the record
B3_TIMED = ("cell", "piled", "init")
# (N, H, W) of the cell's logits, and (R, P) of the synthetic cases
B3_CELL = (8, 544, 960)
B3_ROWS = {"r1": (1, 100_003), "p_odd": (17, 123_457), "other": (17, 500_000)}


# the phase-9 cases built from logits, which phase 10 also runs B4f on
B4F_CASES = ("cell", "per_image_136", "classes_to_ignore", "init")


def logits_case(name, dev):
    """(float32 logits (N, 17, H, W), labels (N, H, W), classes_to_ignore,
    per_image) of one B4F_CASES case: seeded 3 x randn logits and blocky
    labels at the cell's shape, its per-image form and a
    `classes_to_ignore` case at half the height and width; 0.1 x randn
    logits ("init": the near-uniform softmax of an untrained net)."""
    seed = sum(map(ord, name))
    gen = torch.Generator(device=dev).manual_seed(seed)
    rng = np.random.default_rng(seed)
    n, h, w = B3_CELL
    if name == "classes_to_ignore":
        n, h, w = 2, h // 2, w // 2
    std = 0.1 if name == "init" else 3.0
    logits = std * torch.randn((n, 17, h, w), generator=gen, device=dev)
    labels = torch.as_tensor(blocky_labels(rng, n, h, w, 18, 8), device=dev)
    return (logits, labels, 17 if name == "classes_to_ignore" else None,
            name == "per_image_136")


def b3_inputs(name, dev):
    """(errors (R, P) float32, fg (R, P) bool) of one phase-9 case: the
    rows of `lovasz_rows` from seeded logits (3 x randn) and blocky labels
    for the cell (17 x 8·544·960), its per-image form (136 x 544·960) and a
    `classes_to_ignore` case, and at the cell's shape from 0.1 x randn
    logits ("init": the near-uniform softmax of an untrained net);
    synthetic rows for the others ("misaligned": views one float and two
    bytes into their storage, so that neither a row's errors nor its flags
    start 16-byte aligned, nor alike; "above_one": 30 % of the errors in
    [1, 3), which bf16 rounds above 1, 10 % in (-2^-12, 0], negative errors
    of bucket 0, and 5 % in (-1.5, -0.5], negative ids counted nowhere)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
        lovasz_rows)

    if name in B4F_CASES:
        logits, labels, ignore, per_image = logits_case(name, dev)
        e, fg, _ = lovasz_rows(logits, labels, ignore, per_image=per_image)
        return e.contiguous(), fg.contiguous()
    seed = sum(map(ord, name))
    gen = torch.Generator(device=dev).manual_seed(seed)
    r_rows, p = B3_ROWS.get(name, B3_ROWS["other"])
    u = torch.rand((r_rows, p), generator=gen, device=dev)
    if name == "zeros":
        e = torch.zeros_like(u)
    elif name == "ones":
        e = torch.ones_like(u)
    elif name == "piled":       # 45 % in bucket 0, 45 % in bucket 2047
        which = torch.rand((r_rows, p), generator=gen, device=dev)
        e = torch.where(which < 0.45, u * (2.0 ** -11) * 0.999,
                        torch.where(which < 0.9, 1.0 - u * 2.0 ** -12, u))
    elif name == "above_one":
        which = torch.rand((r_rows, p), generator=gen, device=dev)
        e = torch.where(which < 0.3, 1.0 + 2.0 * u,
                        torch.where(which < 0.4, -u * 2.0 ** -12,
                                    torch.where(which < 0.45, -0.5 - u, u ** 3)))
    elif name == "edges":       # k/2048 and its float32 neighbours
        k = torch.arange(2049, dtype=torch.float32, device=dev) / 2048
        row = torch.cat([k, torch.nextafter(k, torch.tensor(2.0, device=dev)),
                         torch.nextafter(k, torch.tensor(-1.0, device=dev)).clamp_min(0)])
        e = row.repeat(r_rows, 1)
    else:
        e = u ** 3
    fg = torch.rand(e.shape, generator=gen, device=dev) < 0.3
    if name == "misaligned":
        e = torch.cat([e.new_zeros(1), e.flatten()])[1:].view(e.shape)
        fg = torch.cat([fg.new_zeros(2), fg.flatten()])[2:].view(fg.shape)
    return e.contiguous(), fg


def se_float64(e, fg):
    """(R, 2, 2048) float64 sums of bf16(e) per [bg, fg] bucket."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
        N_BUCKETS, bucket_ids)
    bid = bucket_ids(e)
    row = torch.arange(e.shape[0], device=e.device)[:, None]
    key = ((row * 2 + fg.long()) * N_BUCKETS + bid)[bid >= 0]
    se = torch.zeros(e.shape[0] * 2 * N_BUCKETS, dtype=torch.float64, device=e.device)
    se.index_add_(0, key, e.to(torch.bfloat16).double()[bid >= 0])
    return se.reshape(e.shape[0], 2, N_BUCKETS)


def b3_hot_shares(got: torch.Tensor, pairs: int) -> dict:
    """The share of pairs in each of the four hot bins (buckets 0 and 2047
    of the bg and fg halves) of a (R, 2048, 4) histogram."""
    return {f"{half}_{b}": float(got[:, b, col].sum()) / pairs
            for half, col in (("bg", 1), ("fg", 0)) for b in (0, 2047)}


def check_b3(dev) -> dict:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        bucket_histogram, bucket_histogram_plain)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.bucket_hist import (
        bucket_stats_plain)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
        losses_and_tables)

    record = None
    for name in B3_CASES:
        e, fg = b3_inputs(name, dev)
        got = bucket_histogram(e, fg)
        again = bucket_histogram(e, fg)
        ref = bucket_histogram_plain(e, fg)
        stats_k, stats_p = bucket_histogram.stats(e, fg), bucket_stats_plain(e, fg)
        se64 = se_float64(e, fg)
        torch.cuda.synchronize()
        r_rows, p = e.shape
        counts_equal = torch.equal(got[..., :2], ref[..., :2])
        # the int32 counts and int64 fixed-point sums themselves
        stats_equal = all(map(torch.equal, stats_k, stats_p))
        equal = torch.equal(got, ref)
        repeat = torch.equal(got, again)
        se_k = got[..., [3, 2]].transpose(1, 2).double()     # (R, [bg, fg], B)
        n_b0 = got[:, 0, [1, 0]].double()
        # sums are negative where negative errors of bucket 0 outweigh
        allowed = (2.0 ** -24 + 1e-9) * se64.abs()
        allowed[..., 0] += n_b0 * 2.0 ** -48
        se_err = (se_k - se64).abs()
        se_ok = bool((se_err <= allowed).all())
        se_rel = float((se_err / se64.abs().clamp_min(1e-30)).max())
        per_k = losses_and_tables(got)[0]
        per_p = losses_and_tables(ref)[0]
        hist64 = torch.stack([got[..., 0].double(), got[..., 1].double(),
                              se64[:, 1], se64[:, 0]], dim=-1)
        per64 = losses_and_tables(hist64)[0]
        loss_err = float((per_k.double() - per64).abs().max())
        hot = float((got[:, 0, :2].sum() + got[:, -1, :2].sum()) / (r_rows * p))
        print(f"B3 {name}: R={r_rows} P={p} counts_equal={counts_equal} "
              f"counts_and_sums_equal={stats_equal} "
              f"bit_equal_to_plain={equal} two_runs_bit_equal={repeat} "
              f"se_within_f32_rounding_of_f64={se_ok} se_max_rel_vs_f64={se_rel!r} "
              f"per_class_loss_max_abs_vs_f64={loss_err!r} "
              f"pairs_in_buckets_0_and_2047={hot!r}", flush=True)
        if not (counts_equal and stats_equal and equal and repeat and se_ok
                and torch.equal(per_k, per_p) and loss_err <= 1e-5):
            raise AssertionError(f"B3 {name} disagrees with its plain version "
                                 "or the float64 sums")
        if name in B3_TIMED:
            kernel_ms = cuda_ms(lambda: bucket_histogram(e, fg))
            plain_ms = cuda_ms(lambda: bucket_histogram_plain(e, fg), reps=5)
            n_bytes = 4 * e.numel() + fg.numel() + 4 * got.numel()
            line = _record(bucket_histogram, float((got - ref).abs().max()),
                           kernel_ms, plain_ms, n_bytes,
                           B3_OPS_PER_PAIR * e.numel(),
                           f"B3 {name} ({e.numel()} pairs, {hot!r} of them "
                           "in buckets 0 and 2047; per hot bin "
                           f"{json.dumps(b3_hot_shares(got, e.numel()))})")
            if name == "cell":
                record = line
        del e, fg, got, again, ref, se64, stats_k, stats_p
    return record


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of `x` (2^-133, the smallest bf16
    subnormal, at 0 and below the normal range)."""
    _, exp = torch.frexp(x.float())
    return torch.where(x == 0, 2.0 ** -133, torch.exp2((exp - 8).clamp_min(-133).float()))


def loss_cotangent(present: torch.Tensor, n: int, per_image: bool) -> torch.Tensor:
    """d loss / d per_row of `lovasz_softmax` at its defaults: the mean over
    the present classes (of each image, then over the images, per image)."""
    pr = present.reshape(n if per_image else 1, -1)
    return (pr / pr.sum(1, keepdim=True).clamp_min(1.0) / pr.shape[0]).reshape(-1)


def parent_lovasz_softmax(logits, labels, classes_to_consider=None,
                          classes_to_ignore=None, per_image=False, impl="bucket"):
    """`lovasz_softmax(impl="bucket")` as the parent commit computes it:
    autograd through `lovasz_rows` (softmax, |fg - p|, the transpose), then
    B3 and B4 behind `bucket_lovasz_per_class`. Phase 10 times its backward
    beside the new route's; phase 11 reads HRNetv2's peak memory with it."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
        bucket_lovasz_per_class)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
        _mean_over, lovasz_rows)

    if impl != "bucket":
        raise ValueError("the parent's composition is the generic bucket route's")
    n, c = logits.shape[:2]
    if classes_to_consider in (None, "present", "all"):
        class_mask = torch.ones(c, device=logits.device)
    else:
        class_mask = torch.zeros(c, device=logits.device)
        class_mask[torch.as_tensor(classes_to_consider, dtype=torch.long)] = 1.0
    errors_t, fg_t, present = lovasz_rows(logits, labels, classes_to_ignore, per_image)
    per_class = bucket_lovasz_per_class(errors_t, fg_t)
    rows = n if per_image else 1
    weight = class_mask.repeat(rows)
    if classes_to_consider != "all":
        weight = weight * present
    return _mean_over(per_class.reshape(rows, c), weight.reshape(rows, c)).mean()


def check_b4(dev) -> tuple[dict, dict]:
    """B4 bit-equal to its plain version at every B3_CASES shape, two runs
    bit-equal; its time at the cell (the call, CUDA events; the kernel
    alone, profiler)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        bucket_gather, bucket_gather_plain, bucket_histogram)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
        grad_table, losses_and_tables)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_grad_ablation import (
        device_ms)

    record = None
    for name in B3_CASES:
        e, fg = b3_inputs(name, dev)
        _, gts, g_fg, g_bg = losses_and_tables(bucket_histogram(e, fg))
        present = (gts > 0).float()
        table = grad_table(g_fg, g_bg, present / present.sum().clamp_min(1.0))
        got = bucket_gather(e, fg, table)
        again = bucket_gather(e, fg, table)
        ref = bucket_gather_plain(e, fg, table)
        torch.cuda.synchronize()
        equal, repeat = torch.equal(got, ref), torch.equal(got, again)
        print(f"B4 {name}: R={e.shape[0]} P={e.shape[1]} bit_equal_to_plain="
              f"{equal} two_runs_bit_equal={repeat} nonzero="
              f"{int((got != 0).sum())}", flush=True)
        if not (equal and repeat):
            raise AssertionError(f"B4 {name} disagrees with its plain version")
        if name == "cell":
            kernel_ms = cuda_ms(lambda: bucket_gather(e, fg, table))
            plain_ms = cuda_ms(lambda: bucket_gather_plain(e, fg, table), reps=5)
            alone = device_ms(lambda: bucket_gather(e, fg, table),
                              kernel="bucket_gather_kernel")
            print(f"B4 cell: the kernel alone {alone!r} ms (profiler, median of 20), "
                  f"{alone / kernel_ms!r} of the call's {kernel_ms!r} ms", flush=True)
            n_bytes = 4 * e.numel() + fg.numel() + 4 * table.numel() + 4 * got.numel()
            record = _record(bucket_gather, float((got - ref).abs().max()),
                             kernel_ms, plain_ms, n_bytes,
                             B4_OPS_PER_PAIR * e.numel(), "B4 cell")
        del e, fg, got, again, ref
    return record


def check_b4f(dev) -> dict:
    """B4f at every B4F_CASES case in float32 and bf16 against its plain
    version (float32: relative L2 <= 1e-6 and largest difference <= 1e-5 of
    the largest element; bf16: every element within one bf16 ulp of the
    plain result) and in float32 against the parent's composition (autograd
    through `lovasz_rows` into B4; relative L2 <= 1e-5), two runs
    bit-equal, the table from the loss's cotangent on a B3 forward of the
    same inputs; at the cell its time in both types (the call, CUDA events;
    the kernel alone, profiler) and the loss backward of one HRNetv2 step
    (`torch.autograd.grad` from the loss to the bf16 logits) on the parent's
    composition and on the new route, in turns, with each route's peak
    memory over the loss's forward and backward."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        bucket_dlogits, bucket_dlogits_plain, bucket_histogram)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
        bucket_lovasz_per_class, grad_table, losses_and_tables)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
        lovasz_rows)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_grad_ablation import (
        device_ms)

    record, failed = None, []
    for name in B4F_CASES:
        logits32, labels, ignore, per_image = logits_case(name, dev)
        n = logits32.shape[0]
        for dtype in (torch.float32, torch.bfloat16):
            logits = logits32.to(dtype)
            e, fg, present = lovasz_rows(logits, labels, ignore, per_image)
            e, fg = e.contiguous(), fg.contiguous()
            _, _, g_fg, g_bg = losses_and_tables(bucket_histogram(e, fg))
            ct = loss_cotangent(present, n, per_image)
            table = grad_table(g_fg, g_bg, ct)
            got = bucket_dlogits(e, fg, table, logits, per_image=per_image)
            again = bucket_dlogits(e, fg, table, logits, per_image=per_image)
            ref = bucket_dlogits_plain(e, fg, table, logits, per_image)
            torch.cuda.synchronize()
            repeat = torch.equal(got, again)
            diff = (got.float() - ref.float()).abs()
            max_abs, top = float(diff.max()), float(ref.float().abs().max())
            what = f"B4f {name} ({dtype}, per_image={per_image})"
            if dtype == torch.float32:
                rel = rel_l2(got, ref)
                x = logits.detach().requires_grad_(True)
                e_a, fg_a, _ = lovasz_rows(x, labels, ignore, per_image)
                (parent,) = torch.autograd.grad(
                    (bucket_lovasz_per_class(e_a, fg_a) * ct).sum(), x)
                rel_parent = rel_l2(got, parent)
                print(f"{what}: relative L2 to plain {rel!r}, max abs {max_abs!r} "
                      f"(largest element {top!r}); relative L2 to the parent's "
                      f"composition {rel_parent!r}; two_runs_bit_equal={repeat}",
                      flush=True)
                ok = rel <= 1e-6 and max_abs <= 1e-5 * top and rel_parent <= 1e-5
                del x, e_a, fg_a, parent
            else:
                ulps = float((diff / bf16_ulp(ref)).max())
                n_off = int((got != ref).sum())
                print(f"{what}: largest difference from plain {ulps!r} bf16 ulps "
                      f"({n_off} of {got.numel()} elements differ), max abs "
                      f"{max_abs!r}; two_runs_bit_equal={repeat}", flush=True)
                ok = ulps <= 1.0
            if not (ok and repeat):
                failed.append(what)
            if name == "cell":
                def fn():
                    return bucket_dlogits(e, fg, table, logits, per_image=per_image)
                kernel_ms = cuda_ms(fn)
                plain_ms = cuda_ms(
                    lambda: bucket_dlogits_plain(e, fg, table, logits, per_image), reps=5)
                alone = device_ms(fn, kernel="bucket_dlogits_kernel")
                print(f"{what}: the kernel alone {alone!r} ms (profiler, median of 20), "
                      f"{alone / kernel_ms!r} of the call's {kernel_ms!r} ms", flush=True)
                size = logits.element_size()
                n_bytes = ((4 + 1 + 2 * size) * e.numel() + 4 * table.numel())
                line = _record(bucket_dlogits, max_abs, kernel_ms, plain_ms, n_bytes,
                               B4F_OPS_PER_PAIR * e.numel(), what)
                if dtype == torch.bfloat16:
                    record = line
            del logits, e, fg, got, again, ref, diff
    if failed:
        raise AssertionError(f"B4f disagrees: {failed}")
    loss_backward(dev)
    return record


def loss_backward(dev) -> None:
    """The loss backward of one HRNetv2 step at the cell's shape, bf16
    logits: `torch.autograd.grad` from the loss to the logits on the
    parent's composition and on the new route (retained graphs), timed in
    turns (parent, new, new, parent; CUDA events, median of 20, the host
    included; and the device's work alone, `queued_ms`), their gradients
    compared, and each route's peak memory over the loss's forward and
    backward."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
        lovasz_softmax)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_grad_ablation import (
        queued_ms)

    logits32, labels, _, _ = logits_case("cell", dev)
    x = logits32.to(torch.bfloat16).requires_grad_(True)
    del logits32
    routes = {"parent": parent_lovasz_softmax,
              "new": lambda lg, lb: lovasz_softmax(lg, lb, impl="bucket")}
    losses, grads, peaks, launches = {}, {}, {}, {}
    for name, route in routes.items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        losses[name] = route(x, labels)
        (grads[name],) = torch.autograd.grad(losses[name], x, retain_graph=True)
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        launches[name] = {k: v for k, v in launch_counts().items() if v}
    times, device = {}, {}
    for name in ("parent", "new", "new", "parent"):
        def backward():
            return torch.autograd.grad(losses[name], x, retain_graph=True)
        times.setdefault(name, []).append(cuda_ms(backward))
        device.setdefault(name, []).append(queued_ms(backward))
    rel = rel_l2(grads["new"], grads["parent"])
    print(f"HRNetv2 loss backward at the cell (bf16 logits 8x17x544x960; ms, "
          f"CUDA events, median of 20, two turns): {json.dumps(times)}; its device "
          f"work (CUDA events over calls queued behind a spin, the host hidden): "
          f"{json.dumps(device)}; losses "
          f"{losses['parent'].item()!r} (parent) and {losses['new'].item()!r} (new); "
          f"gradients {int((grads['new'] != grads['parent']).sum())} of "
          f"{x.numel()} elements apart, relative L2 {rel!r}; peak memory over the "
          f"loss's forward and backward above the logits (bytes): "
          f"{json.dumps(peaks)}; launches {json.dumps(launches)}", flush=True)
    # the two gradients are two float32 VJPs apart (held to 1e-5 above in
    # float32), each rounded to bf16 once: within a bf16 rounding, 2^-8
    if losses["parent"].item() != losses["new"].item() or rel > 2.0 ** -8:
        raise AssertionError("the new route's loss or gradient disagrees with the parent's")


# ---------------------------------------------------------------------------
# phase 11: the HRNetv2-W32 cell at full width
# ---------------------------------------------------------------------------

def hrnet_config(width: int = 32) -> dict:
    with open(HR_CONFIG) as f:
        cfg = json.load(f)
    return dict(cfg, graph={"model": "HRNetv2", "width": width},
                loss=dict(HR_LOSS))


def run_cell(dev, cfg, what: str, expect: dict, batch_check,
             n_frames: int = 29, hw=(540, 960), profile: bool = True) -> dict:
    """`validate` and `train_steps` of one cell with the kernels' counts
    read around each (`expect["eval"]` launches per eval-loss batch,
    `expect["train"]` per train step, none of any other kernel), the
    eval-loss step's time (outside the counted run),
    `batch_check(model, images, labels, eval_step, spec)` on one full
    batch, a
    10-step overfit of one batch (pad only) whose loss must fall at every
    step, the train step's time and profile; returns the launch counts of
    `train_steps`."""
    import copy

    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import pad_reflect_hw
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_spec, make_eval_loss_step, make_train_step)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
        train_metrics_source, train_steps)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import validate

    task, bs = int(cfg["data"]["experiment"]), 8
    n_cls = 17
    images, labels = synthetic_set(n_frames, *hw)
    model = build_model(cfg["graph"], task, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    n_full = len(images) // bs
    spec = eval_spec(cfg["data"]["transforms"])
    loss_fn = build_loss(cfg["loss"], task, dev)
    eval_step = make_eval_loss_step(loss_fn, spec, dev, cfg.get("precision", "bf16"))
    eval_step(model, images[:bs], labels[:bs], 0)        # warm-up
    torch.cuda.synchronize()

    def expected(per, n):
        return dict(dict.fromkeys(KERNELS, 0), **{k: v * n for k, v in per.items()})

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = validate(model, cfg, images, labels, device=dev, batch_size=bs)
    torch.cuda.synchronize()
    val_launches = launch_counts()
    val_peak = torch.cuda.max_memory_allocated()
    cm = res["confusion_matrix"]
    n_counted = int((pad_reflect_hw(torch.as_tensor(labels)) < n_cls).sum())
    eval_ms = cuda_ms(lambda: eval_step(model, images[:bs], labels[:bs], 0),
                      reps=10, warmup=1)
    print(f"{what} validate: " + json.dumps({k: res[k] for k in (
        "valid_loss", "miou", "pa", "pac")}) + f"; {n_params} parameters; "
          f"kernel launches {val_launches}; cm total {int(cm.sum())} of "
          f"{n_counted}; peak memory {val_peak} bytes; eval-loss step "
          f"{eval_ms!r} ms (CUDA events, median of 10) = "
          f"{bs / eval_ms * 1e3!r} frames/s", flush=True)
    if val_launches != expected(expect["eval"], n_full):
        raise AssertionError(f"kernel launches in validate {val_launches}, "
                             f"expected {expect['eval']} per batch ({n_full})")
    if not (np.isfinite(res["valid_loss"]) and int(cm.sum()) == n_counted):
        raise AssertionError(f"{what} validate: loss {res['valid_loss']}, "
                             f"cm {int(cm.sum())} of {n_counted}")
    batch_check(model, images[:bs], labels[:bs], eval_step, spec)

    batches = list(np.arange(n_full * bs).reshape(n_full, bs))
    train_steps(copy.deepcopy(model), cfg, images, labels, batches[:1], device=dev)
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    res = train_steps(model, cfg, images, labels, batches, device=dev)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"{what} train_steps: " + json.dumps({k: res[k] for k in (
        "loss", "miou", "pa", "step_losses", "seconds", "frames_per_s")})
          + f"; {n_full} steps of {bs} frames; peak memory {peak} bytes; "
          f"kernel launches {launches}; cm total "
          f"{int(res['confusion_matrix'].sum())}", flush=True)
    if launches != expected(expect["train"], n_full):
        raise AssertionError(f"kernel launches in train_steps {launches}, "
                             f"expected {expect['train']} per step ({n_full})")
    if not np.isfinite(res["step_losses"]).all():
        raise AssertionError(f"{what} train losses {res['step_losses']}")

    # the overfit sees one batch under the pad alone, so that each step's
    # loss is the same function of the weights
    fit_cfg = dict(cfg, data=dict(cfg["data"], transforms=["pad"]))
    fit = train_steps(copy.deepcopy(model), fit_cfg, images, labels,
                      [batches[0]] * 10, device=dev, seed=1)
    losses = fit["step_losses"]
    print(f"{what} overfit, 10 steps on one batch (pad only): losses {losses}",
          flush=True)
    if not (np.isfinite(losses).all() and all(np.diff(losses) < 0)):
        raise AssertionError(f"the {what} overfit loss does not fall at every "
                             f"step: {losses}")

    state = res["state"]
    step = make_train_step(loss_fn, device_spec(cfg["data"]["transforms"]), task,
                           device=dev, precision=cfg.get("precision", "bf16"),
                           train_metrics=train_metrics_source(cfg))
    imgs, lbls = images[:bs], labels[:bs]
    step_ms = cuda_ms(lambda: step(state, imgs, lbls, 0), reps=10, warmup=2)
    print(f"{what} train step: {step_ms!r} ms (CUDA events, median of 10) = "
          f"{bs / step_ms * 1e3!r} frames/s", flush=True)
    if profile:
        groups = profile_step(lambda: step(state, imgs, lbls, 0), f"{what} train")
        total = sum(groups.values())
        shares = {g: v / total for g, v in groups.items() if g.startswith("B")}
        print(f"{what} train step shares of the device kernel time: "
              + json.dumps(shares), flush=True)
    return launches


def hrnet_batch_check(model, images, labels, eval_step, spec) -> None:
    """One full batch's HRNetv2 loss: the step's, B3's, B3's plain
    version's (equal) and the exact sort's."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import bucket_histogram_plain
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
        bucket_lovasz_per_class)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
        lovasz_rows, lovasz_softmax)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_preprocess)

    dev = next(model.parameters()).device
    with torch.inference_mode():
        _, _, _, step_loss = eval_step(model, images, labels, 0)
        x, lbl = eval_preprocess(torch.as_tensor(images).to(dev), spec,
                                 torch.as_tensor(labels).to(dev))
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            logits = model(x)["logits"]
        e, fg, present = lovasz_rows(logits, lbl)
        per_k = bucket_lovasz_per_class(e, fg)
        per_p = bucket_lovasz_per_class(e, fg, histogram=bucket_histogram_plain)
        loss_k = float((per_k * present).sum() / present.sum())
        loss_p = float((per_p * present).sum() / present.sum())
        loss_sort = float(lovasz_softmax(logits, lbl, impl="sort"))
        del x, lbl, logits, e, fg, present, per_k, per_p
    print(f"HRNetv2 batch 0 loss: step {float(step_loss)!r}, kernel {loss_k!r}, "
          f"plain B3 {loss_p!r}, exact sort {loss_sort!r}", flush=True)
    if loss_k != loss_p or abs(loss_k - float(step_loss)) > 1e-6:
        raise AssertionError("HRNetv2 batch loss: kernel, plain and step disagree")


def hrnet_route_memory(dev, cfg, n_frames: int = 8) -> None:
    """HRNetv2's peak memory and step time through `train_steps` of one
    full batch on the parent's composition of the generic bucket route
    (`parent_lovasz_softmax`, put in place of `lovasz_softmax` while the
    loss is built) and on the new route, in turns (new, parent, parent,
    new), each from a copy of one seed-0 model."""
    import copy

    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import functional
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import train_steps

    images, labels = synthetic_set(n_frames)
    model = build_model(cfg["graph"], int(cfg["data"]["experiment"]), device=dev, seed=0)
    new_route = functional.lovasz_softmax
    peaks, seconds = {}, {}
    for name in ("new", "parent", "parent", "new"):
        functional.lovasz_softmax = new_route if name == "new" else parent_lovasz_softmax
        try:
            run = copy.deepcopy(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            res = train_steps(run, cfg, images, labels, [np.arange(n_frames)], device=dev)
            torch.cuda.synchronize()
        finally:
            functional.lovasz_softmax = new_route
        peaks.setdefault(name, []).append(torch.cuda.max_memory_allocated())
        seconds.setdefault(name, []).append(res["seconds"])
        del run, res
    print(f"HRNetv2 train_steps of one batch of {n_frames} on each route, in turns: "
          f"peak memory (bytes) {json.dumps(peaks)}; seconds {json.dumps(seconds)}",
          flush=True)


def deeplab_batch_check(model, images, labels, eval_step, spec) -> None:
    """One full batch's DeepLab loss: the step's, B1's at R = C rows and
    B1's plain version's (within 1e-5, B1's convention)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        fu_histogram, fu_histogram_plain)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        fused_bucket_lovasz_s8)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_preprocess)

    dev = next(model.parameters()).device
    with torch.inference_mode():
        _, _, _, step_loss = eval_step(model, images, labels, 0)
        x, lbl = eval_preprocess(torch.as_tensor(images).to(dev), spec,
                                 torch.as_tensor(labels).to(dev))
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            s8 = model(x, full_res=())["logits_s8"]
        loss_k = float(fused_bucket_lovasz_s8(s8, lbl, histogram=fu_histogram))
        loss_p = float(fused_bucket_lovasz_s8(s8, lbl, histogram=fu_histogram_plain))
        del x, lbl, s8
    print(f"DeepLabv3 batch 0 loss: step {float(step_loss)!r}, kernel {loss_k!r}, "
          f"plain B1 {loss_p!r}", flush=True)
    if abs(loss_k - loss_p) > 1e-5 or abs(loss_k - float(step_loss)) > 1e-6:
        raise AssertionError("DeepLabv3 batch loss: kernel, plain and step disagree")


# ---------------------------------------------------------------------------
# phase 13: B5-B8 against their plain versions
# ---------------------------------------------------------------------------

# float32 operations per counted (pixel, class row) pair: B5/B7 5 for the
# softmax (max, subtract, exp, sum, divide) and 2 for e = |fg - p|; B6/B8
# those 7, 1 for the sign of the gathered de and 4 for the softmax VJP
NCHW_HIST_OPS_PER_PAIR = 7
NCHW_GRAD_OPS_PER_PAIR = 7 + 1 + 4

NCHW_CASES = [
    # name, scales run, N, C, s8 (hs, ws) or None for raw grids, (H, W), B,
    # edges, ignore class
    ("flagship", (2,), 8, 17, (68, 120), (544, 960), 1024, "uniform", None),
    ("deeplab_cell", (1,), 8, 17, (68, 120), (544, 960), 2048, "uniform", None),
    ("c5", (2, 1), 2, 5, (17, 30), (136, 240), 1024, "uniform", None),
    ("c25_b2048", (2, 1), 2, 25, (17, 30), (136, 240), 2048, "uniform", None),
    ("odd_w125_live_lanes", (2, 1), 2, 17, None, (67, 125), 1024, "uniform", None),
    ("all_ignore_image", (2, 1), 2, 17, (17, 30), (136, 240), 1024, "uniform", 17),
    ("classes_to_ignore", (2, 1), 2, 17, (17, 30), (136, 240), 1024, "uniform", 3),
    ("adaptive", (2, 1), 2, 17, (34, 60), (272, 480), 1024, "adaptive", None),
    ("b256", (2, 1), 2, 17, (34, 60), (272, 480), 256, "uniform", None),
    ("b2048", (2, 1), 2, 17, (34, 60), (272, 480), 2048, "uniform", None),
    # the flagship's grids from the logits of a net that has learnt (see
    # nchw_inputs): most pairs land in bucket 0 of their half
    ("peaked", (2,), 8, 17, (68, 120), (544, 960), 1024, "uniform", None),
]
# the cases whose times phase 13 prints; flagship and deeplab_cell give the
# kernels' records (B5/B6 and B7/B8)
NCHW_TIMED = ("flagship", "deeplab_cell", "peaked")


def nchw_inputs(case, dev):
    """(grids of both scales, padded int32 labels) of one phase-13 case:
    the v3 route's own `upsample_nchw` of seeded stride-8 logits (for
    "peaked", std 3 plus 15 on the class of the label under each stride-8
    cell, as B1_CASES' peaked row), or, for raw grids, seeded
    full-resolution logits with labels also in the pad lanes, where only
    w_real keeps them from counting."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        pad_labels, upsample_nchw)

    name, _, n, c, s8, (h, w), *_, ignore = case
    rng = np.random.default_rng(sum(map(ord, name)))
    lbl = blocky_labels(rng, n, h, w, c + 1, 8)
    if name == "all_ignore_image":
        lbl[0] = ignore
    raise_ = 0.0
    if name == "peaked":
        under = lbl[:, ::8, ::8][:, :s8[0], :s8[1]]
        raise_ = 15.0 * (under[:, None] == np.arange(c)[None, :, None, None])
    lbl = pad_labels(torch.as_tensor(lbl, device=dev), ignore)
    h_pad, w_pad = lbl.shape[1:]
    if s8 is None:
        grids = [torch.as_tensor(3.0 * rng.standard_normal((n, c, h_pad, w_pad)),
                                 dtype=torch.float32, device=dev) for _ in range(2)]
        live = torch.as_tensor(rng.integers(0, c + 1, (n, h, w_pad - w)),
                               dtype=torch.int32, device=dev)
        lbl[:, :h, w:] = live
    else:
        grids = [upsample_nchw(torch.as_tensor(
            3.0 * rng.standard_normal((n, c) + s8) + raise_, dtype=torch.float32,
            device=dev), (h, w), True, w_pad, h_pad) for _ in range(2)]
    return grids, lbl


def nchw_table(counts, n_scales, n_buckets, edges):
    """The bf16-rounded table of the loss sum_s w_s * mean over present
    classes of scale s (w = 0.4, 1.0 for two scales, 1.0 for one)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        counts_to_hist, grad_table, losses_and_tables)

    _, gts, g_fg, g_bg = losses_and_tables(counts_to_hist(counts, n_buckets, edges))
    present = (gts > 0).float().reshape(n_scales, -1)
    weights = torch.tensor([[0.4], [1.0]] if n_scales == 2 else [[1.0]],
                           device=counts.device)
    ct = (weights * present / present.sum(1, keepdim=True).clamp_min(1.0)).reshape(-1)
    return grad_table(g_fg, g_bg, ct)


def phase13_nchw(dev) -> dict:
    """B5/B7 and B6/B8 against their plain versions at every NCHW_CASES
    shape: row totals equal, histogram L1 <= 1e-3 of the counted pairs,
    the backward's bucket ids reproduce the forward's histogram exactly,
    its gradient equals the plain arithmetic at those ids within float32
    rounding (relative L2 1e-5), two runs of each bit-equal; dither under
    v3 raises; the timings at NCHW_TIMED, each kernel alone (profiler) and
    its share of the call, and the share of counted pairs in the hottest
    bins. Returns the four kernels' records by name, from the flagship
    (B5/B6) and DeepLabv3 cell (B7/B8) shapes."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        nchw1_gradient, nchw1_histogram, nchw_gradient, nchw_grad_plain,
        nchw_histogram, nchw_histogram_plain)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_grad import (
        softmax_vjp_from_fields)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.lovasz_hist import (
        count_fields)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.nchw_hist import (
        nchw_fields)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import fused_lovasz
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.fu_grad_ablation import (
        device_ms)

    records = {}
    for case in NCHW_CASES:
        name, scales, n, c, s8, (h, w), nb, edges, ignore = case
        grids, lbl = nchw_inputs(case, dev)
        lane = torch.arange(lbl.shape[2], device=dev)
        n_counted = int(((lbl >= 0) & (lane < w)).sum())
        for n_scales in scales:
            hist = (nchw1_histogram, nchw_histogram)[n_scales - 1]
            grad = (nchw1_gradient, nchw_gradient)[n_scales - 1]
            g = grids[:n_scales]
            kw = dict(n_buckets=nb, edges=edges, w_real=w)
            got = hist(g, lbl, **kw)
            again = hist(g, lbl, **kw)
            ref = nchw_histogram_plain(g, lbl, **kw)
            table = nchw_table(got, n_scales, nb, edges)
            dz, bids = grad.with_bucket_ids(g, lbl, table, **kw)
            dz_again = grad(g, lbl, table, **kw)
            dz_ref = nchw_grad_plain(g, lbl, table, **kw)
            p, fg, keep, pbid = nchw_fields(g, lbl, **kw)
            kbid = bids.reshape(pbid.shape).long()
            same_ids = softmax_vjp_from_fields(p, fg, keep, kbid, table)
            torch.cuda.synchronize()
            pairs = n_scales * c * n_counted
            rows_equal = bool(torch.equal(got.sum((1, 2)), ref.sum((1, 2))))
            diff = (got.long() - ref.long()).abs()
            l1, max_abs = int(diff.sum()), int(diff.max())
            hist_repeat = bool(torch.equal(got, again))
            ids_equal = bool(torch.equal(count_fields(fg, keep, kbid, nb), got))
            dz_k = torch.stack(dz, dim=1)
            rel_same = rel_l2(dz_k, same_ids) if same_ids.norm() > 0 else float(dz_k.norm())
            same_max_abs = float((dz_k - same_ids).abs().max())
            dz_p = torch.stack(dz_ref, dim=1)
            rel_plain = rel_l2(dz_k, dz_p) if dz_p.norm() > 0 else float(dz_k.norm())
            g_max_abs = float((dz_k - dz_p).abs().max())
            grad_repeat = all(torch.equal(a, b) for a, b in zip(dz, dz_again))
            dead = float(dz_k.abs().sum(dim=(1, 2))[~keep].sum()) if (~keep).any() else 0.0
            print(f"{hist.name}/{grad.name} {name}: N={n} C={c} grid={tuple(lbl.shape[1:])} "
                  f"w_real={w} B={nb} edges={edges} ignore={ignore} pairs={pairs} "
                  f"row_totals_equal={rows_equal} hist_l1={l1} hist_max_abs={max_abs} "
                  f"hist_two_runs_bit_equal={hist_repeat} "
                  f"grad_ids_reproduce_hist={ids_equal} "
                  f"grad_rel_l2_vs_plain_at_kernel_ids={rel_same!r} "
                  f"grad_rel_l2_vs_plain={rel_plain!r} grad_max_abs_vs_plain={g_max_abs!r} "
                  f"grad_two_runs_bit_equal={grad_repeat} "
                  f"grad_on_uncounted_pixels={dead!r}", flush=True)
            print(f"{grad.name} {name}: the gradient's largest absolute difference from "
                  f"the plain version at the kernel's bucket ids {same_max_abs!r}", flush=True)
            if not (rows_equal and hist_repeat and l1 <= 1e-3 * max(pairs, 1)):
                raise AssertionError(f"{hist.name} {name} disagrees with its plain "
                                     f"version (L1 {l1} of {pairs} pairs)")
            if not (ids_equal and grad_repeat and rel_same <= 1e-5 and dead == 0.0):
                raise AssertionError(f"{grad.name} {name} disagrees with its plain "
                                     "arithmetic or with the forward's buckets")
            if name in NCHW_TIMED:
                print(f"{hist.name} {name}: hot-bin shares "
                      f"{json.dumps(hot_bin_shares(got))}", flush=True)
                hist_ms = cuda_ms(lambda: hist(g, lbl, **kw))
                hist_plain_ms = cuda_ms(lambda: nchw_histogram_plain(g, lbl, **kw), reps=5)
                grad_ms = cuda_ms(lambda: grad(g, lbl, table, **kw))
                grad_plain_ms = cuda_ms(lambda: nchw_grad_plain(g, lbl, table, **kw),
                                        reps=5)
                # what the function needs of its inputs: the labels of the
                # lanes below w_real and the logits of the counted pixels;
                # B6/B8 write every element of their gradient grids
                read = 4 * pairs + 4 * lbl[:, :, :w].numel()
                hist_rec = _record(
                    hist, max_abs, hist_ms, hist_plain_ms, read + 4 * got.numel(),
                    NCHW_HIST_OPS_PER_PAIR * pairs, f"{hist.name} {name}")
                grad_rec = _record(
                    grad, g_max_abs, grad_ms, grad_plain_ms,
                    read + 4 * table.numel() + 4 * sum(t.numel() for t in g),
                    NCHW_GRAD_OPS_PER_PAIR * pairs, f"{grad.name} {name}")
                for kernel, call_ms, fn in (
                        (hist, hist_ms, lambda: hist(g, lbl, **kw)),
                        (grad, grad_ms, lambda: grad(g, lbl, table, **kw))):
                    alone = device_ms(fn, kernel=os.path.basename(kernel.source)[:-3]
                                      + "_kernel")
                    print(f"{kernel.name} {name}: the kernel alone {alone!r} ms "
                          f"(profiler, median of 20), {alone / call_ms!r} of the "
                          f"call's {call_ms!r} ms", flush=True)
                if name != "peaked":
                    records[hist.name], records[grad.name] = hist_rec, grad_rec
            del got, again, ref, table, dz, bids, dz_again, dz_ref, p, fg, keep
            del pbid, kbid, same_ids, dz_k, dz_p
        del grids, lbl

    # the v3 route refuses dither, as the JAX package's does
    s8 = torch.zeros((1, 5, 4, 4), device=dev)
    labels = torch.zeros((1, 32, 32), dtype=torch.int64, device=dev)
    fused_lovasz._USE_V3 = True
    try:
        for call in (lambda: fused_lovasz.fused_bucket_lovasz_s8(s8, labels, dither_seed=1),
                     lambda: fused_lovasz.fused_two_scale_bucket_lovasz_s8(
                         s8, s8, labels, 0.4, 1.0, dither_seed=1)):
            try:
                call()
            except ValueError as exc:
                print(f"dither under v3 raises: {exc}", flush=True)
            else:
                raise AssertionError("dither under v3 did not raise")
    finally:
        fused_lovasz._USE_V3 = False
    return records


# ---------------------------------------------------------------------------
# phases 14-15: the DeepLabv3 cell, DeepLabv3+ validation, the v3 route
# ---------------------------------------------------------------------------

def deeplab_config(graph: dict | None = None) -> dict:
    """configs/DeepLabv3_rf_lvsz.json (DeepLabv3-R50 os8) with the bucket
    Lovász, or with another graph."""
    with open(HR_CONFIG) as f:
        cfg = json.load(f)
    return dict(cfg, graph=graph or cfg["graph"], loss=dict(HR_LOSS))


def validate_deeplabv3plus(dev) -> None:
    """One `validate` of DeepLabv3+-R50 os8 at full width: B1 at a stride-4
    source (136 x 240 -> 544 x 960), one launch per eval-loss batch."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import pad_reflect_hw
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import validate

    cfg = deeplab_config(dict(deeplab_config()["graph"], model="DeepLabv3Plus"))
    images, labels = synthetic_set()
    model = build_model(cfg["graph"], 2, device=dev, seed=0)
    validate(model, cfg, images[:8], labels[:8], device=dev, batch_size=8)   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = validate(model, cfg, images, labels, device=dev, batch_size=8)
    seconds = time.perf_counter() - t0
    launches = launch_counts()
    n_full = len(images) // 8
    cm = res["confusion_matrix"]
    n_counted = int((pad_reflect_hw(torch.as_tensor(labels)) < 17).sum())
    print("DeepLabv3+ validate: " + json.dumps({k: res[k] for k in (
        "valid_loss", "miou", "pa", "pac")}) + f"; {seconds!r} s wall; kernel "
          f"launches {launches}; cm total {int(cm.sum())} of {n_counted}", flush=True)
    if launches != dict(dict.fromkeys(KERNELS, 0), fu_hist=n_full):
        raise AssertionError(f"kernel launches in DeepLabv3+ validate {launches}")
    if not (np.isfinite(res["valid_loss"]) and int(cm.sum()) == n_counted):
        raise AssertionError("DeepLabv3+ validate: loss or confusion matrix")


V3_KERNELS = {"DeepLabv3": ("nchw1_hist", "nchw1_grad"),
              "OCRNet": ("nchw_hist", "nchw_grad")}


def run_v3_route(dev, what: str, cfg, n_steps: int = 3) -> dict:
    """`train_steps` of one cell on the v3 route (`_USE_V3` set around the
    calls) with the kernels' counts read around it: one launch each of its
    v3 pair per step and no other; one batch's loss and the gradient of the
    pre-upsample logits, v3 against v4 (loss within 1e-5, gradient within
    relative L2 1e-4, the JAX package's own check); the train step's time
    on each route, in turns. Returns the launch counts."""
    import copy

    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss, fused_lovasz
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_preprocess, eval_spec, make_train_step)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
        train_metrics_source, train_steps)

    task, bs = int(cfg["data"]["experiment"]), 8
    images, labels = synthetic_set()
    model = build_model(cfg["graph"], task, device=dev, seed=0)
    batches = list(np.arange(n_steps * bs).reshape(n_steps, bs))
    loss_fn = build_loss(cfg["loss"], task, dev)
    step = make_train_step(loss_fn, device_spec(cfg["data"]["transforms"]), task,
                           device=dev, precision=cfg.get("precision", "bf16"),
                           train_metrics=train_metrics_source(cfg))
    try:
        fused_lovasz._USE_V3 = True
        train_steps(copy.deepcopy(model), cfg, images, labels, batches[:1], device=dev)
        torch.cuda.synchronize()
        reset_launches()
        res = train_steps(model, cfg, images, labels, batches, device=dev)
        launches = launch_counts()
    finally:
        fused_lovasz._USE_V3 = False
    hist, grad = V3_KERNELS[what]
    print(f"{what} v3 train_steps: " + json.dumps({k: res[k] for k in (
        "loss", "step_losses", "seconds", "frames_per_s")})
          + f"; {n_steps} steps of {bs} frames; kernel launches {launches}",
          flush=True)
    if launches != dict(dict.fromkeys(KERNELS, 0), **{hist: n_steps, grad: n_steps}):
        raise AssertionError(f"kernel launches in {what}'s v3 train_steps "
                             f"{launches}, expected one {hist} and one {grad} per step")
    if not np.isfinite(res["step_losses"]).all():
        raise AssertionError(f"{what} v3 train losses {res['step_losses']}")

    # one batch: v3 against v4 from the same pre-upsample logits
    with torch.no_grad():
        x, lbl = eval_preprocess(torch.as_tensor(images[:bs]).to(dev),
                                 eval_spec(cfg["data"]["transforms"]),
                                 torch.as_tensor(labels[:bs]).to(dev))
        model.eval()
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            out = model(x, full_res=())
    s8 = {k: v.float() for k, v in out.items() if k.endswith("_s8")}
    results = {}
    for v3 in (True, False):
        leaves = {k: v.clone().requires_grad_(True) for k, v in s8.items()}
        fused_lovasz._USE_V3 = v3
        try:
            total = loss_fn(leaves, lbl)[0]
            total.backward()
        finally:
            fused_lovasz._USE_V3 = False
        results[v3] = (float(total.detach()), {k: t.grad for k, t in leaves.items()})
    (l3, g3), (l4, g4) = results[True], results[False]
    rels = {k: rel_l2(g3[k], g4[k]) for k in g3}
    print(f"{what} batch 0, v3 against v4: loss {l3!r} vs {l4!r}; gradient "
          f"relative L2 {json.dumps(rels)}", flush=True)
    if abs(l3 - l4) > 1e-5 or max(rels.values()) > 1e-4:
        raise AssertionError(f"{what}: the v3 route disagrees with v4")

    imgs, lbls = images[:bs], labels[:bs]
    state = res["state"]

    def timed(v3):
        fused_lovasz._USE_V3 = v3
        try:
            return cuda_ms(lambda: step(state, imgs, lbls, 0), reps=5, warmup=1)
        finally:
            fused_lovasz._USE_V3 = False

    order = (False, True, True, False)
    times = [timed(v3) for v3 in order]
    v4_ms = [t for t, v3 in zip(times, order) if not v3]
    v3_ms = [t for t, v3 in zip(times, order) if v3]
    print(f"{what} train step, v4 then v3, v3, v4 (CUDA events, median of 5 "
          f"each): v4 {v4_ms!r} ms, v3 {v3_ms!r} ms", flush=True)
    # the device time each route's step needs, apart from host gaps
    for v3 in (False, True):
        fused_lovasz._USE_V3 = v3
        try:
            profile_step(lambda: step(state, imgs, lbls, 0),
                         f"{what} train ({'v3' if v3 else 'v4'})")
        finally:
            fused_lovasz._USE_V3 = False
    return launches


# ---------------------------------------------------------------------------
# phase 17: P1/P2 against their plain versions, then the prototype's main
# ---------------------------------------------------------------------------

P_CASES = [
    # name, N, C (R = 2C rows), (h, ws), out (H, W), (h_pad, ws_pad, W_pad),
    # align_corners
    ("proto", 8, 18, (68, 120), (544, 960), (72, 128, 1024), True),
    ("acf", 2, 18, (68, 120), (544, 960), (72, 128, 1024), False),
    ("c17", 2, 17, (68, 120), (544, 960), (72, 128, 1024), True),
    ("odd", 2, 5, (9, 16), (67, 125), (16, 32, 128), True),
    ("one_image", 1, 18, (68, 120), (544, 960), (72, 128, 1024), True),
    # no size a multiple of a tile, rows not 16-byte aligned
    ("ragged", 1, 3, (11, 13), (83, 101), (13, 13, 101), False),
]


def p_inputs(case, dev):
    """(both scales' logits, ls2d, mhT, mw, d) of one phase-17 case."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.proto_fused_upsample import (
        prep, upsample_mats)

    name, n, c, (h, ws), out_hw, pads, align = case
    rng = np.random.default_rng(sum(map(ord, name)))
    li, lf = (torch.as_tensor(rng.standard_normal((n, c, h, ws)),
                              dtype=torch.float32, device=dev) for _ in range(2))
    ls2d = prep(li, lf, out_hw, *pads)[0]
    mhT, mw = upsample_mats(h, ws, out_hw, *pads, align, dev)
    d = torch.as_tensor(rng.standard_normal((n, 2 * c, out_hw[0], pads[2])),
                        dtype=torch.float32, device=dev)
    return (li, lf), ls2d, mhT, mw, d


def phase17_fused_upsample(dev) -> dict:
    """P1 and P2 against float64 evaluations of the same products (relative
    L2 <= 1e-6), P1 against `upsample_nchw` of both scales (1e-4 abs), P2's
    two runs bit-equal, at P_CASES; the prototype's shape timed (kernel, its
    plain version, the library call); then the prototype counterpart's
    `main` on the card with the launch counts read around it. Returns P1's
    and P2's records."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels.fused_upsample import (
        fused_downsample, fused_downsample_plain, fused_upsample, fused_upsample_plain)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        upsample_nchw)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import proto_fused_upsample

    records = {}
    for case in P_CASES:
        name, n, c, (h, ws), out_hw, (h_pad, ws_pad, w_pad), align = case
        parts, ls2d, mhT, mw, d = p_inputs(case, dev)
        mwT = mw.t().contiguous()
        rows = 2 * c
        up = fused_upsample(ls2d, mhT, mw, rows)
        up_again = fused_upsample(ls2d, mhT, mw, rows)
        up_plain = fused_upsample_plain(ls2d, mhT, mw, rows)
        up64 = fused_upsample_plain(ls2d.double(), mhT.double(), mw.double(), rows)
        ref = torch.cat([upsample_nchw(x, out_hw, align, w_pad, out_hw[0])
                         for x in parts], dim=1)
        down = fused_downsample(d, mhT, mwT)
        down_again = fused_downsample(d, mhT, mwT)
        down_plain = fused_downsample_plain(d, mhT, mwT)
        down64 = fused_downsample_plain(d.double(), mhT.double(), mwT.double())
        torch.cuda.synchronize()
        got = dict(
            p1_rel_l2_vs_f64=rel_l2(up, up64),
            p1_max_abs_vs_upsample_nchw=float((up - ref).abs().max()),
            p1_max_abs_vs_plain=float((up - up_plain).abs().max()),
            p1_two_runs_bit_equal=bool(torch.equal(up, up_again)),
            p2_rel_l2_vs_f64=rel_l2(down, down64),
            p2_max_abs_vs_plain=float((down - down_plain).abs().max()),
            p2_two_runs_bit_equal=bool(torch.equal(down, down_again)))
        print(f"P1/P2 {name}: N={n} R={rows} {h}x{ws} -> {out_hw[0]}x{out_hw[1]} "
              f"pads {h_pad}/{ws_pad}/{w_pad} align_corners={align}: "
              + json.dumps(got), flush=True)
        if not (got["p1_rel_l2_vs_f64"] <= 1e-6 and got["p2_rel_l2_vs_f64"] <= 1e-6
                and got["p1_max_abs_vs_upsample_nchw"] <= 1e-4
                and got["p2_two_runs_bit_equal"]):
            raise AssertionError(f"P1/P2 {name}: {got}")
        if name != "proto":
            continue
        # the bound: the contraction without its pads in the cheaper of its
        # two orders (rows or columns first), and every byte of the inputs
        # and outputs once; the kernels do the operations as three TF32
        # products on the tensor cores, so the bound counts them three times
        # at the dense TF32 rate (the bound at the float32 rate outside the
        # tensor cores, which earlier records used, is printed beside it)
        big_h, big_w = out_hw
        ops = 2.0 * n * rows * min(big_h * ws * (h + big_w), h * big_w * (ws + big_h))
        for kernel, plain, library, args, max_abs, n_bytes, what in (
                (fused_upsample, fused_upsample_plain,
                 lambda: [upsample_nchw(x, out_hw, align, w_pad, out_hw[0])
                          for x in parts], (ls2d, mhT, mw, rows),
                 got["p1_max_abs_vs_plain"],
                 4 * (ls2d.numel() + mhT.numel() + mw.numel() + up.numel()),
                 "P1 proto"),
                (fused_downsample, fused_downsample_plain,
                 lambda: torch.einsum("Hh,nrHW,Ww->nrhw", mhT, d, mwT),
                 (d, mhT, mwT), got["p2_max_abs_vs_plain"],
                 4 * (d.numel() + mhT.numel() + mwT.numel() + down.numel()),
                 "P2 proto")):
            ms = cuda_ms(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            library_ms = cuda_ms(library)
            rec = _record(kernel, max_abs, ms, plain_ms, n_bytes, 3 * ops, what,
                          PEAK_TF32_OPS_S, "TF32 (3 x the contraction's)")
            rec["library_ms"] = library_ms
            simt_ms = max(n_bytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S) * 1e3
            issued = kernel.issued_flops(*args)
            print(f"{what}: library call {library_ms!r} ms (CUDA events, "
                  f"median of 20); float32-SIMT bound {simt_ms!r} ms; the "
                  f"tiles issue {issued / 1e9!r} GFLOP (float32 work, "
                  f"{ops / 1e9!r} without pads); kernel/bound "
                  f"{ms / rec['bound_ms']!r}, kernel/library "
                  f"{ms / library_ms!r}", flush=True)
            records[kernel.name] = rec
        del up, up_again, up_plain, up64, ref, down, down_again, down_plain, down64

    reset_launches()
    res = proto_fused_upsample.main("cuda")
    torch.cuda.synchronize()
    launches = launch_counts()
    print("prototype counterpart main: " + json.dumps(res)
          + f"; kernel launches {launches}", flush=True)
    p_names = ("fused_upsample", "fused_downsample")
    if (any(launches[k] for k in KERNELS if k not in p_names)
            or not all(launches[k] for k in p_names)):
        raise AssertionError(f"kernel launches in the prototype's main {launches}")
    for k in p_names:
        records[k]["launches"] = launches[k]
    return records


# ---------------------------------------------------------------------------
# phases 18-19: the EncDec-UPerNet-R34 cell, and its train step card vs CPU
# ---------------------------------------------------------------------------

def upernet_config() -> dict:
    """configs/UPN_rf_lvsz.json as shipped (its EncDec graph from the
    top-level encoder and decoder) with its LossWrapper sent to the fused
    route."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import load_config

    return dict(load_config(UPN_CONFIG), loss=dict(UPN_LOSS))


def upernet_batch_check(model, images, labels, eval_step, spec) -> None:
    """One full batch's UPerNet loss: the step's, B1's from the stride-4
    `logits_s8_acf` at align_corners=False, and B1's plain version's (within
    1e-5, B1's convention)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        fu_histogram, fu_histogram_plain)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.fused_lovasz import (
        fused_bucket_lovasz_s8)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_preprocess)

    dev = next(model.parameters()).device
    with torch.inference_mode():
        _, _, _, step_loss = eval_step(model, images, labels, 0)
        x, lbl = eval_preprocess(torch.as_tensor(images).to(dev), spec,
                                 torch.as_tensor(labels).to(dev))
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            s4 = model(x, full_res=())["logits_s8_acf"]
        loss_k = float(fused_bucket_lovasz_s8(s4, lbl, align_corners=False,
                                              histogram=fu_histogram))
        loss_p = float(fused_bucket_lovasz_s8(s4, lbl, align_corners=False,
                                              histogram=fu_histogram_plain))
        del x, lbl, s4
    print(f"UPerNet batch 0 loss: step {float(step_loss)!r}, kernel {loss_k!r}, "
          f"plain B1 {loss_p!r}", flush=True)
    if abs(loss_k - loss_p) > 1e-5 or abs(loss_k - float(step_loss)) > 1e-6:
        raise AssertionError("UPerNet batch loss: kernel, plain and step disagree")


PRETRAINED = ("OCRNet_pretrained_t1.json", "OCRNet_pretrained_t2.json",
              "OCRNet_pretrained_t3.json")
TEST_VIDEOS = (2, 12, 22)           # split 2's test videos
LEFT_OUT = (1, 3, 4)                # training videos, which inference leaves out


def counted_pixels(canonical: np.ndarray, task: int) -> int:
    """Pixels of padded frames whose `task` label is a class (not ignore)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import pad_reflect_hw
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.remap import remap_mask_np
    from miccai2021_cataract_semantic_segmentation_tpu_torch.taxonomy import TASK_NUM_CLASSES

    lbl = torch.as_tensor(remap_mask_np(canonical, task))
    return int((pad_reflect_hw(lbl) < TASK_NUM_CLASSES[task]).sum())


def decode_timings(root) -> dict:
    """ms per frame of the decoders on the tree's test frames (image and
    label), and of the two PNG unfilters on one RGB frame, every row type."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data import (
        SegDataset, load_frame_table, native_io, png, split_dataframes)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.png import filter_rows

    valid = split_dataframes(load_frame_table(data_path=str(root)), 2, "inference")[1]
    ds = SegDataset(valid, 2, str(root))
    out = {}
    t = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    out["png_ms_per_frame"] = (time.perf_counter() - t) * 1e3 / len(ds)
    if native_io.available():
        t = time.perf_counter()
        for k in range(0, len(ds), 8):
            ds.load_batch(list(range(k, min(k + 8, len(ds)))))
        out["native_ms_per_frame"] = (time.perf_counter() - t) * 1e3 / len(ds)
    frame = ds[0][0]
    rows = filter_rows(frame, np.arange(frame.shape[0]) % 5)
    for name, fn in (("numpy", png.unfilter_plain), ("cpp", png.unfilter_native)):
        t = time.perf_counter()
        for _ in range(3):
            fn(rows, 3)
        out[f"unfilter_{name}_ms"] = (time.perf_counter() - t) * 1e3 / 3
    return out


def write_served_tree(data, images, canon) -> None:
    """Phase 20's CaDIS tree: the frames under split 2's test videos, in
    turn, and the first three again under training videos."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
        write_tree)

    write_tree(data, np.concatenate([images, images[:len(LEFT_OUT)]]),
               np.concatenate([canon, canon[:len(LEFT_OUT)]]),
               [TEST_VIDEOS[i % 3] for i in range(len(images))] + list(LEFT_OUT))


def phase20_served(dev) -> None:
    """The served path from PNGs on disk: a synthetic CaDIS tree, the three
    published inference configs through the port's CLI, the flagship's
    `Trainer.validate(0)`, the decoders' times and `infer`'s frames/s."""
    import shutil
    import tempfile

    import importlib.util

    from miccai2021_cataract_semantic_segmentation_tpu_torch.data import (
        DECODED, ArrayDataset, native_io, png, reset_decoded)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
        canonical_from_network)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.checkpoint import (
        save_checkpoint)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import parse_config
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import validate

    images, labels = synthetic_set()
    n = len(images)
    canon = canonical_from_network(labels, 2)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_served_"))
    data, logs = tmp / "data", tmp / "logs"
    try:
        t = time.perf_counter()
        write_served_tree(data, images, canon)
        # build the host libraries once, before the CLI's processes start;
        # the PNG path's C++ unfilter raises where it does not build
        native_ok = native_io.available()
        png.unfilter_lib()
        print(f"served tree: {n} test frames + {len(LEFT_OUT)} left out, written "
              f"in {time.perf_counter() - t!r} s; native decoder built: {native_ok} "
              f"({native_io.build_error()}); C++ unfilter built; "
              "installed here: " + ", ".join(
                  m for m in ("pandas", "cv2", "PIL", "matplotlib", "tensorboard")
                  if importlib.util.find_spec(m) is not None), flush=True)

        # (a) the published inference configs through the CLI, one process each
        models, infos = {}, {}
        for name in PRETRAINED:
            cfg = json.loads((pathlib.Path(ROOT) / "configs" / name).read_text())
            task = int(cfg["data"]["experiment"])
            run = f"published_t{task}"
            models[task] = build_model(cfg["graph"], task, device=dev, seed=0)
            save_checkpoint(logs / run / "chkpts", "best", models[task], 0, 0.0, 0.0)
            cfg.update(data_path=str(data), log_path=str(logs), load_checkpoint=run)
            cfg_path = tmp / name
            cfg_path.write_text(json.dumps(cfg))
            t = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m",
                 "miccai2021_cataract_semantic_segmentation_tpu_torch.main",
                 "-c", str(cfg_path), "-dp", str(data)],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            seconds = time.perf_counter() - t
            if proc.returncode != 0:
                raise AssertionError(f"CLI on {name} exited {proc.returncode}:\n"
                                     f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
            (found,) = logs.glob(f"*_e{task}__{cfg['name']}/info.json")
            m = infos[task] = json.loads(found.read_text())["metrics"]
            cm = np.asarray(m["confusion_matrix"], np.int64)
            print(f"CLI {name}: {seconds!r} s wall (process included); " + json.dumps(
                {k: m[k] for k in ("miou", "pa", "pac", "frames_per_sec", "decoded",
                                   "valid_batch_size", "device")}), flush=True)
            expected = counted_pixels(canon, task)
            if int(cm.sum()) != expected or not np.isfinite(m["miou"]) or \
                    sum(m["decoded"].values()) != -(-n // m["valid_batch_size"]):
                raise AssertionError(f"CLI {name}: {int(cm.sum())} pixels counted of "
                                     f"{expected}, decoded {m['decoded']}")
        cfg2 = json.loads((tmp / PRETRAINED[1]).read_text())
        ref = validate(models[2], cfg2, images, labels, device=dev, batch_size=8)
        if not np.array_equal(ref["confusion_matrix"],
                              np.asarray(infos[2]["confusion_matrix"])):
            diff = int(np.abs(ref["confusion_matrix"]
                              - np.asarray(infos[2]["confusion_matrix"])).sum())
            raise AssertionError(f"t2's CLI matrix differs from validate's in {diff}")
        print(f"CLI t2's confusion matrix equals validate's on the arrays "
              f"({int(ref['confusion_matrix'].sum())} pixels)", flush=True)

        # infer's frames/s at the pretrained configs' batch size (1) and at 8
        for bs in (1, 8):
            tcfg = dict(parse_config(str(tmp / PRETRAINED[1])), valid_batch_size=bs,
                        run_id=f"infer_bs{bs}")
            trainer = Trainer(tcfg, device=dev)
            trainer.load_checkpoint("best", run_id="published_t2")
            res = trainer.infer()
            trainer.close()
            print(f"infer t2 at valid batch {bs}: {res['frames_per_sec']!r} "
                  f"frames/s (host clock, one warm-up batch excluded; decoded "
                  f"{res['decoded']})", flush=True)

        # where infer's time goes: without the triptych images, then also
        # from memory (no decode), then the eval step alone on the card
        arrays = ArrayDataset(images, labels)
        for bs in (8, 1):
            base = dict(parse_config(str(tmp / PRETRAINED[1])), valid_batch_size=bs,
                        max_valid_imgs=0)
            fps = {}
            for what, datasets in (("no images", None),
                                   ("from memory", (arrays, arrays, None, None))):
                trainer = Trainer(dict(base, run_id=f"parts_bs{bs}"), datasets,
                                  device=dev)
                trainer.load_checkpoint("best", run_id="published_t2")
                fps[what] = trainer.infer()["frames_per_sec"]
                trainer.close()
            x = torch.as_tensor(images[:bs]).to(dev)
            y = torch.as_tensor(labels[:bs]).to(dev)
            step_ms = cuda_ms(lambda: trainer.eval_step(trainer.model, x, y), reps=10)
            print(f"infer t2 at valid batch {bs}, its parts: {fps['no images']!r} "
                  f"frames/s without the triptych images, {fps['from memory']!r} "
                  f"also from memory (no decode); the eval step alone {step_ms!r} "
                  f"ms (CUDA events, median of 10) = {bs / step_ms * 1e3!r} frames/s",
                  flush=True)

        # (b) the flagship's Trainer.validate(0) from disk: one B1 a full batch
        fcfg = dict(parse_config(CONFIG), data_path=str(data), log_path=str(logs),
                    mode="inference", run_id="flagship")
        trainer = Trainer(fcfg, device=dev)
        reset_launches()
        reset_decoded()
        t = time.perf_counter()
        got = trainer.validate(0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        launches, decoded = launch_counts(), dict(DECODED)
        trainer.close()
        n_full = n // trainer.valid_batch_size
        want = validate(trainer.model, fcfg, images, labels, device=dev,
                        batch_size=trainer.valid_batch_size)
        print(f"flagship Trainer.validate(0) from disk: {seconds!r} s wall; loss "
              f"{got['valid_loss']!r} (validate on the arrays {want['valid_loss']!r}); "
              f"miou {got['miou']!r}; launches {launches}; decoded {decoded}", flush=True)
        if launches != dict(dict.fromkeys(KERNELS, 0), fu_hist=n_full):
            raise AssertionError(f"launches {launches}, expected {n_full} of B1 only")
        if got["valid_loss"] != want["valid_loss"] or not np.array_equal(
                np.asarray(got["confusion_matrix"]), want["confusion_matrix"]):
            raise AssertionError("Trainer.validate and validate disagree")

        timing = decode_timings(data)
        print("decoders (ms per frame, image and label; host clock): " + json.dumps(
            timing) + f"; decoder on the served path: "
            f"{'native' if native_ok else 'png'}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 21: training through the port's Trainer and CLI from PNGs on disk
# ---------------------------------------------------------------------------

# split 2's training frames and its validation frames (videos 5, 7, 16)
TRAIN_FRAMES, VALID_FRAMES = 24, 8
# task-2 classes of the training frames: the common ones in every frame's
# blocks; each rare one in one block of one frame only (f = 1/24 < 0.15, so
# that frame repeats r = 1.897 times: sum r(I) is about 32, so the epochs
# run 3 or 4 batches of 8)
COMMON_CLASSES = (0, 1, 2, 3, 4, 5, 6, 7, 17)
RARE_CLASSES = (8, 9, 10, 11, 12, 13, 14, 15, 16)


def train_from_disk_set(h=540, w=960, seed=0, block=60):
    """Seeded task-2 frames for phase 21: the training frames (the first
    TRAIN_FRAMES) of COMMON_CLASSES in block x block tiles, frame i <
    len(RARE_CLASSES) with one tile of rare class i; the validation frames
    of all 18 values; images whose colour follows the label, plus noise."""
    rng = np.random.default_rng(seed)
    n = TRAIN_FRAMES + VALID_FRAMES
    labels = blocky_labels(rng, n, h, w, 18, block).astype(np.uint8)
    common = np.asarray(COMMON_CLASSES, np.uint8)
    labels[:TRAIN_FRAMES] = common[labels[:TRAIN_FRAMES] % len(common)]
    for i, cls in enumerate(RARE_CLASSES):
        labels[i, :block, block * i:block * (i + 1)] = cls
    palette = rng.integers(0, 256, (18, 3))
    noise = rng.integers(-20, 21, (n, h, w, 3))
    images = np.clip(palette[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels


def flat_floats(state_dict: dict) -> torch.Tensor:
    """A state dict's floating-point entries (parameters and BatchNorm
    statistics) in one float64 vector."""
    return torch.cat([v.reshape(-1).double() for v in state_dict.values()
                      if v.dtype.is_floating_point])


def phase21_train_from_disk(dev) -> dict:
    """The flagship recipe trained through the port's CLI from a synthetic
    CaDIS tree: run A (in process, its kernels' launches counted and
    epoch 1 traced), a repeat (the card's run-to-run spread), and run B
    interrupted at epoch 2's validation and resumed by the CLI in a
    subprocess; returns A's launch counts."""
    import shutil
    import tempfile

    from miccai2021_cataract_semantic_segmentation_tpu_torch import main as port_main
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data import (
        SegDataset, load_frame_table, reset_decoded, split_dataframes)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.samplers import (
        RepeatFactorSampler)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.taxonomy import DATA_SPLITS
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
        canonical_from_network, write_tree)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.checkpoint import (
        read_checkpoint)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer

    cfg = json.loads(pathlib.Path(CONFIG).read_text())
    task, bs, epochs = int(cfg["data"]["experiment"]), int(cfg["data"]["batch_size"]), 3
    images, labels = train_from_disk_set()
    train_videos, valid_videos = DATA_SPLITS[2][0], DATA_SPLITS[2][1]
    videos = [train_videos[i % len(train_videos)] for i in range(TRAIN_FRAMES)] + \
        [valid_videos[i % len(valid_videos)] for i in range(VALID_FRAMES)]
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_train_"))
    data, logs = tmp / "data", tmp / "logs"
    try:
        t = time.perf_counter()
        write_tree(data, images, canonical_from_network(labels, task), videos)
        print(f"train tree: {TRAIN_FRAMES} training + {VALID_FRAMES} validation "
              f"frames written in {time.perf_counter() - t!r} s", flush=True)

        # the index streams a host replay of the samplers gives, seed + 1
        train_df = split_dataframes(load_frame_table(data_path=str(data)), 2,
                                    blacklist=cfg["data"]["blacklist"])[0]
        sampler = RepeatFactorSampler(train_df, cfg["data"]["repeat_factor_freq_thresh"],
                                      task, blacklist=cfg["data"]["blacklist"],
                                      seed=int(cfg["seed"]) + 1)
        replay = [sampler.epoch_batches(bs) for _ in range(epochs)]
        steps = [len(b) for b in replay]
        print(f"sum r(I) = {float(sampler.repeat_factors.sum())!r} over "
              f"{len(train_df)} frames (largest r {float(sampler.repeat_factors.max())!r}); "
              f"steps per epoch {steps}", flush=True)
        if len(train_df) != TRAIN_FRAMES or len(set(steps)) < 2:
            raise AssertionError(f"the set should give epochs of varying length: {steps}")
        n_steps = sum(steps)

        def write_config(name, **changes):
            c = json.loads(json.dumps(cfg))
            c["train"]["epochs"] = epochs
            c.update(data_path=str(data), log_path=str(logs), log_every_n_epochs=1,
                     **changes)
            path = tmp / f"{name}.json"
            path.write_text(json.dumps(c))
            return path

        # record each Trainer's per-epoch train metrics, as it validates
        epoch_log: list[dict] = []
        validate = Trainer.validate

        def logging_validate(self, epoch):
            epoch_log.append(dict(self.train_metrics, run=self.run_id))
            return validate(self, epoch)

        Trainer.validate = logging_validate
        try:
            # run A: the uninterrupted run, traced at epoch 1, counted
            path_a = write_config("run_a", run_id="run_a", profile_epoch=1)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            reset_decoded()
            t = time.perf_counter()
            metrics_a = port_main.main(["-c", str(path_a), "-dp", str(data)])
            torch.cuda.synchronize()
            wall_a = time.perf_counter() - t
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated()

            # the repeat: the card's own spread between two identical runs
            path_r = write_config("repeat", run_id="repeat")
            t = time.perf_counter()
            port_main.main(["-c", str(path_r), "-dp", str(data)])
            wall_r = time.perf_counter() - t

            # run B: stopped entering epoch 2's validation, in process
            class Stopped(Exception):
                pass

            trainer = Trainer(json.loads(write_config("run_b", run_id="run_b").read_text()),
                              device=dev)

            def interrupted(epoch):
                if epoch == 2:
                    raise Stopped("run B stopped at epoch 2's validation")
                return logging_validate(trainer, epoch)

            trainer.validate = interrupted
            t = time.perf_counter()
            try:
                trainer.train()
            except Stopped:
                pass
            else:
                raise AssertionError("run B was not interrupted")
            finally:
                trainer.close()
            wall_b = time.perf_counter() - t
        finally:
            Trainer.validate = validate
        del trainer
        torch.cuda.empty_cache()

        # ... resumed by the CLI in a subprocess from run B's `last`
        path_b = write_config("resume_b", run_id="run_b", load_checkpoint="run_b")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "miccai2021_cataract_semantic_segmentation_tpu_torch.main",
             "-c", str(path_b), "-dp", str(data)],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall_resume = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"the resume exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        resumed_lines = [ln for ln in proc.stdout.splitlines() if "epoch 002" in ln]

        # where an epoch's time goes: the decode of its frames on one thread
        ds = SegDataset(train_df, task, str(data))
        t = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        decode_ms = (time.perf_counter() - t) * 1e3 / len(ds)
        for rec in epoch_log:
            share = decode_ms * rec["steps"] * bs / (rec["seconds"] * 1e3)
            print(f"{rec['run']} epoch {rec['epoch']}: {rec['steps']} steps, "
                  f"{rec['ms_per_step']!r} ms/step (StepTimer, host clock), "
                  f"{rec['frames_per_s']!r} frames/s, {rec['seconds']!r} s, "
                  f"loss {rec['loss']!r}, miou {rec['miou']!r}; the decode "
                  f"({decode_ms!r} ms a frame) {share!r} of the epoch", flush=True)
        print(f"run A: {wall_a!r} s wall in process (main); the repeat {wall_r!r} s; "
              f"run B to its interruption {wall_b!r} s; the CLI's resume "
              f"{wall_resume!r} s wall (a process of its own): {resumed_lines}; "
              f"peak memory of run A {peak} bytes; A's validation: miou "
              f"{metrics_a['miou']!r}, loss {metrics_a['valid_loss']!r}", flush=True)

        # gates: launches, index streams, checkpoints, resume, trace
        # the Trainer's valid batch: 8 on the card (1 on the CPU)
        n_valid_full = VALID_FRAMES // (8 if dev.type == "cuda" else 1)
        want = dict(dict.fromkeys(KERNELS, 0), fu_hist=n_steps + epochs * n_valid_full,
                    fu_grad=n_steps)
        print(f"run A's launches {launches}, expected {want}", flush=True)
        if launches != want:
            raise AssertionError(f"Trainer.train launched {launches}, expected {want}")
        runs = {name: (read_checkpoint(logs / name / "chkpts" / "chkpt_last.pt"),
                       np.load(logs / name / "ind_dist.npz"))
                for name in ("run_a", "repeat", "run_b")}
        ckpt_a, dist_a = runs["run_a"]
        if int(dist_a["ind_counts"].sum()) != n_steps * bs or not np.array_equal(
                dist_a["ind_counts"], np.bincount(np.concatenate(replay).reshape(-1),
                                                  minlength=TRAIN_FRAMES)):
            raise AssertionError("run A's ind_counts differ from the samplers' replay")
        for e, b in enumerate(replay):
            if not np.array_equal(dist_a[f"batches_e{e:03d}"], b):
                raise AssertionError(f"run A's epoch {e} batches differ from the replay")
        if ckpt_a["global_step"] != n_steps or not ckpt_a["optimizer_state_dict"]["state"]:
            raise AssertionError(f"run A's last checkpoint: step {ckpt_a['global_step']} "
                                 f"of {n_steps}, optimiser state "
                                 f"{len(ckpt_a['optimizer_state_dict']['state'])}")
        ckpt_b, dist_b = runs["run_b"]
        if ckpt_b["global_step"] != n_steps or sorted(dist_b.files) != sorted(
                dist_a.files) or any(not np.array_equal(dist_b[k], dist_a[k])
                                     for k in dist_a.files):
            raise AssertionError("run B's step, index counts or batches differ from A's")
        weights_a = flat_floats(ckpt_a["model_state_dict"])
        spread = rel_l2(flat_floats(runs["repeat"][0]["model_state_dict"]), weights_a)
        apart = rel_l2(flat_floats(ckpt_b["model_state_dict"]), weights_a)
        print(f"final parameters and BatchNorm statistics, relative L2 from run A: "
              f"the repeat {spread!r}, the resumed run B {apart!r}", flush=True)
        if apart > 2 * spread or (spread == 0 and apart != 0):
            raise AssertionError(f"run B lies {apart!r} from A, the spread is {spread!r}")
        trace = (logs / "run_a" / "profile" / "trace.json").read_text()
        named = {k: trace.count(k) for k in ("fu_hist_kernel", "fu_grad_kernel")}
        print(f"run A's epoch-1 trace: {len(trace)} bytes; kernel names {named}",
              flush=True)
        if not all(named.values()):
            raise AssertionError(f"the trace does not name B1 and B2: {named}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phases 22-23: the contrastive recipe and the loss zoo, semi-supervised
# self-training, from PNGs on disk
# ---------------------------------------------------------------------------

POOL_FRAMES = 8                      # the unlabelled pool of phase 23
POOL_VIDEOS = (2, 12, 22)            # split 2's test videos: training leaves them out
CONTRASTIVE_PROJECTOR = {"d": 256, "mlp": [[1, 512, 1]], "use_bn": True}
ZOO_LOSSES = ("OhemCrossEntropy", "FocalLoss", "GenDiceLoss", "SoftIoU", "LovaszSoftmax")
# the flagship's full-resolution logits and its projector's features
ZOO_SHAPE = (8, 17, 544, 960)
FEATURE_SHAPE = (8, 256, 68, 120)
# one half of the semi batch: the labelled or the pseudo-labelled frames
SEMI_HALF_SHAPE = (4, 17, 544, 960)
SEMI_THRESHOLD = 0.9


def write_semi_tree(root) -> pathlib.Path:
    """Phase 21's training and validation frames and POOL_FRAMES more under
    split 2's test videos, which training leaves out, as a CaDIS tree."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.taxonomy import DATA_SPLITS
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
        canonical_from_network, write_tree)
    images, labels = train_from_disk_set()
    pool_images, pool_labels = train_from_disk_set(seed=1)
    images = np.concatenate([images, pool_images[:POOL_FRAMES]])
    labels = np.concatenate([labels, pool_labels[:POOL_FRAMES]])
    train_videos, valid_videos = DATA_SPLITS[2][0], DATA_SPLITS[2][1]
    videos = [train_videos[i % len(train_videos)] for i in range(TRAIN_FRAMES)] + \
        [valid_videos[i % len(valid_videos)] for i in range(VALID_FRAMES)] + \
        [POOL_VIDEOS[i % len(POOL_VIDEOS)] for i in range(POOL_FRAMES)]
    t = time.perf_counter()
    write_tree(root, images, canonical_from_network(labels, 2), videos)
    print(f"semi tree: {TRAIN_FRAMES} training, {VALID_FRAMES} validation and "
          f"{POOL_FRAMES} left-out frames written in {time.perf_counter() - t!r} s",
          flush=True)
    return pathlib.Path(root)


class _RunRecorder:
    """Patches the Trainer module around a run: every train step's scalar
    metrics (left on the device until read) and batch shape, and each
    epoch's train metrics as the Trainer validates it."""

    def __init__(self):
        self.steps: list[tuple[int, tuple, dict]] = []
        self.epochs: list[dict] = []

    def __enter__(self):
        from miccai2021_cataract_semantic_segmentation_tpu_torch.train import (
            trainer as trainer_module)
        self.module = trainer_module
        self.make_step, self.validate = trainer_module.make_train_step, \
            trainer_module.Trainer.validate
        recorder = self

        def make_train_step(*args, **kwargs):
            inner = recorder.make_step(*args, **kwargs)

            def step(state, images_u8, labels_u8, epoch, draws=None):
                m = inner(state, images_u8, labels_u8, epoch, draws)
                recorder.steps.append((epoch, tuple(images_u8.shape),
                                       {k: v for k, v in m.items() if v.ndim == 0}))
                return m
            return step

        def validate(trainer, epoch):
            recorder.epochs.append(dict(trainer.train_metrics, run=trainer.run_id))
            return recorder.validate(trainer, epoch)

        trainer_module.make_train_step = make_train_step
        trainer_module.Trainer.validate = validate
        return self

    def __exit__(self, *exc):
        self.module.make_train_step = self.make_step
        self.module.Trainer.validate = self.validate

    def step_values(self, key: str) -> list[tuple[int, float]]:
        return [(epoch, float(m[key])) for epoch, _, m in self.steps]

    def print_epochs(self) -> None:
        for rec in self.epochs:
            print(f"{rec['run']} epoch {rec['epoch']}: {rec['steps']} steps, "
                  f"{rec['ms_per_step']!r} ms/step (StepTimer, host clock), "
                  f"{rec['frames_per_s']!r} frames/s, loss {rec['loss']!r}", flush=True)


def host_warp_ms(h=540, w=960, reps=5) -> dict:
    """Host ms a frame of the recipe's affine warp and of its crop (numpy,
    one thread), median of `reps`."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
        build_transform_pipeline)
    images, labels = train_from_disk_set()
    out = {}
    for name in ("affine", "crop"):
        t = build_transform_pipeline([name], {}, 2).host_train[0]
        times = []
        for k in range(reps):
            t0 = time.perf_counter()
            t(images[k], labels[k], np.random.default_rng(k))
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = statistics.median(times)
    print(f"host transforms, ms a {images.shape[1]}x{images.shape[2]} frame (median of "
          f"{reps}): {out}", flush=True)
    return out


def _cli_run(data, logs, tmp, name: str, cfg: dict, dev):
    """`cfg` through the port's CLI in process, its launches counted and
    its steps recorded; returns (recorder, launches, wall s, peak bytes)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch import main as port_main
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        launch_counts, reset_launches)
    cfg = dict(cfg, data_path=str(data), log_path=str(logs), run_id=name,
               log_every_n_epochs=1)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(cfg))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with _RunRecorder() as rec:
        t = time.perf_counter()
        port_main.main(["-c", str(path), "-dp", str(data)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    rec.print_epochs()
    return rec, launch_counts(), wall, torch.cuda.max_memory_allocated()


def _expect_launches(got: dict, want: dict, what: str) -> None:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import KERNELS
    want = dict(dict.fromkeys(KERNELS, 0), **want)
    print(f"{what}: launches {got}, expected {want}", flush=True)
    if got != want:
        raise AssertionError(f"{what} launched {got}, expected {want}")


def zoo_card_vs_cpu(dev) -> None:
    """Each new loss on the card in float32 against the CPU in float64, value
    and gradient, at the flagship's full-resolution shape (the
    dense-contrastive losses on its projector's features), and
    `sliding_miou` card against CPU."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import contrastive as dc
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import functional as fn
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import sliding_miou
    gen = torch.Generator().manual_seed(22)
    n, c, h, w = ZOO_SHAPE
    logits = torch.randn(ZOO_SHAPE, generator=gen) * 2
    rng = np.random.default_rng(22)
    labels = torch.as_tensor(blocky_labels(rng, n, h, w, c + 1, 8))
    features = torch.randn(FEATURE_SHAPE, generator=gen)
    alpha = np.linspace(0.25, 2.0, c)
    cases = {
        "OhemCrossEntropy": (logits, lambda x, l: fn.ohem_cross_entropy(x, l, c)),
        "FocalLoss": (logits, lambda x, l: fn.focal_loss(x, l, 2.0, alpha, c)),
        "GenDiceLoss": (logits, lambda x, l: fn.generalized_dice(x, l, "auto")),
        "SoftIoU": (logits, lambda x, l: fn.soft_iou(x, l)),
        "DenseContrastiveLoss": (features, lambda x, l: dc.dense_contrastive_loss(x, l, 2)),
        "DenseContrastiveLossV2": (features,
                                   lambda x, l: dc.dense_contrastive_loss_v2(x, l, 2)),
    }
    failed = []
    for name, (x, loss) in cases.items():
        t = time.perf_counter()
        xd = x.to(dev, copy=True).requires_grad_(True)
        vd = loss(xd, labels.to(dev))
        vd.backward()
        torch.cuda.synchronize()
        xc = x.double().requires_grad_(True)
        vc = loss(xc, labels)
        vc.backward()
        rel_v = abs(float(vd.detach()) - float(vc.detach())) / max(abs(float(vc.detach())),
                                                                   1e-30)
        rel_g = rel_l2(xd.grad.cpu().double(), xc.grad)
        print(f"{name} card (float32) vs CPU (float64): value {float(vd.detach())!r} vs "
              f"{float(vc.detach())!r} (relative {rel_v!r}), gradient relative L2 "
              f"{rel_g!r}; {time.perf_counter() - t!r} s", flush=True)
        if not (rel_v <= 1e-5 and rel_g <= 1e-4 and np.isfinite(rel_g)):
            failed.append(name)
        del xd, vd, xc, vc
    got = sliding_miou(logits.to(dev), labels.to(dev)).cpu()
    want = sliding_miou(logits, labels)
    diff = float((got - want).abs().max())
    print(f"sliding_miou card vs CPU at {tuple(logits.shape)}: max abs {diff!r}", flush=True)
    if diff > 1e-6:
        failed.append("sliding_miou")
    if failed:
        raise AssertionError(f"card and CPU disagree on {failed}")


def phase22_contrastive_and_zoo(dev, data) -> dict:
    """(a) The flagship recipe with the projector, the LossWrapper
    {TwoScaleLoss, DenseContrastiveLoss, DenseContrastiveLossV2} at
    dc_off_at_epoch 1 and the affine host warp, 2 epochs through the CLI;
    (b) DeepLabv3+ with the crop and the loss zoo, 2 epochs through the
    CLI; (c) the new losses and sliding_miou card against CPU, and the
    host transforms' ms a frame. Returns the runs' launch counts."""
    import tempfile
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_zoo_"))
    logs = tmp / "logs"
    n_valid_full = VALID_FRAMES // (8 if dev.type == "cuda" else 1)
    out = {}
    try:
        cfg = json.loads(pathlib.Path(CONFIG).read_text())
        cfg["graph"]["projector"] = CONTRASTIVE_PROJECTOR
        cfg["loss"] = {"losses": {"TwoScaleLoss": 1, "DenseContrastiveLoss": 0.1,
                                  "DenseContrastiveLossV2": 0.1},
                       "TwoScaleLoss": cfg["loss"], "dc_off_at_epoch": 1}
        cfg["data"]["transforms"] = cfg["data"]["transforms"] + ["affine"]
        cfg["train"]["epochs"] = 2
        rec, launches, wall, peak = _cli_run(data, logs, tmp, "contrastive", cfg, dev)
        steps = len(rec.steps)
        print(f"(a) contrastive recipe: {steps} steps, {wall!r} s wall in process, peak "
              f"memory {peak} bytes", flush=True)
        _expect_launches(launches, {"fu_hist": steps + 2 * n_valid_full,
                                    "fu_grad": steps}, "(a) contrastive recipe")
        v1, v2 = rec.step_values("DenseContrastiveLoss"), rec.step_values("DenseContrastiveLossV2")
        print(f"(a) DenseContrastiveLoss by step (epoch, value): {v1}; "
              f"DenseContrastiveLossV2: {v2}", flush=True)
        if not (all(v > 0 for e, v in v1 if e == 0) and all(v == 0 for e, v in v1 if e >= 1)
                and {e for e, _ in v1} == {0, 1}):
            raise AssertionError("the V1 term is not on in epoch 0 and 0 from epoch 1")
        if not all(v > 0 and np.isfinite(v) for _, v in v2) or \
                not all(np.isfinite(v) for _, v in rec.step_values("loss")):
            raise AssertionError("a contrastive step's loss is not finite")
        out["contrastive"] = launches

        cfg = json.loads(pathlib.Path(ROOT, "configs", "DeepLabv3Plus_rf_lvsz.json").read_text())
        cfg["data"]["transforms"] = ["crop", "flip", "colorjitter", "torchvision_normalise"]
        cfg["loss"] = {"losses": dict.fromkeys(ZOO_LOSSES, 1.0), "lovasz_impl": "bucket"}
        cfg["train"]["epochs"] = 2
        rec, launches, wall, peak = _cli_run(data, logs, tmp, "zoo", cfg, dev)
        steps = len(rec.steps)
        shapes = sorted({s for _, s, _ in rec.steps})
        from miccai2021_cataract_semantic_segmentation_tpu_torch.data import png
        height = png.png_dimensions(next(pathlib.Path(data).rglob("Images/*.png")))[0]
        crop = int(32 * ((0.4 * height) // 32))
        print(f"(b) loss zoo: {steps} steps of batches {shapes}, {wall!r} s wall in "
              f"process, peak memory {peak} bytes; first and last step's terms "
              f"{[{k: float(v) for k, v in m.items()} for _, _, m in (rec.steps[0], rec.steps[-1])]}",
              flush=True)
        if shapes != [(8, crop, crop, 3)]:
            raise AssertionError(f"the crops reach the step as {shapes}, not {crop}x{crop}")
        _expect_launches(launches, {"fu_hist": steps + 2 * n_valid_full,
                                    "fu_grad": steps}, "(b) loss zoo")
        if not all(np.isfinite(float(v)) for _, _, m in rec.steps for v in m.values()):
            raise AssertionError("a loss-zoo step's term is not finite")
        out["zoo"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    zoo_card_vs_cpu(dev)
    out["warp_ms"] = host_warp_ms()
    return out


def check_semi_half(dev) -> dict:
    """B3 and B4f on one half of the semi batch (SEMI_HALF_SHAPE, both
    scales' rows in one B3, one B4f a scale, pseudo-ignore pixels at 30 %)
    against their plain versions: the histograms bit-equal, the gradients
    as phase 10b holds float32 (relative L2 <= 1e-6, largest difference
    <= 1e-5 of the largest element); with their times at this shape."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        bucket_dlogits, bucket_dlogits_plain, bucket_histogram, bucket_histogram_plain)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
        grad_table, losses_and_tables)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
        lovasz_rows)
    n, c, h, w = SEMI_HALF_SHAPE
    gen = torch.Generator().manual_seed(23)
    scales = [(torch.randn(SEMI_HALF_SHAPE, generator=gen) * s).to(dev) for s in (1.0, 2.0)]
    rng = np.random.default_rng(23)
    labels = blocky_labels(rng, n, h, w, c, 8)
    labels[rng.random(labels.shape) < 0.3] = c           # below the threshold
    labels = torch.as_tensor(labels).to(dev)
    rows = [lovasz_rows(lg, labels, c) for lg in scales]
    e = torch.cat([r[0] for r in rows]).contiguous()
    fg = torch.cat([r[1] for r in rows]).contiguous()
    hist = bucket_histogram(e, fg)
    plain = bucket_histogram_plain(e, fg)
    _, _, g_fg, g_bg = losses_and_tables(hist)
    present = torch.cat([r[2] for r in rows])
    table = grad_table(g_fg, g_bg, present / present.reshape(2, c).sum(1).repeat_interleave(c))
    worst, grads_ok = 0.0, True
    for s, lg in enumerate(scales):
        sl = slice(s * c, (s + 1) * c)
        got = bucket_dlogits(e[sl], fg[sl], table[sl], lg, per_image=False)
        ref = bucket_dlogits_plain(e[sl], fg[sl], table[sl], lg, False)
        max_abs = float((got - ref).abs().max())
        rel = rel_l2(got, ref)
        worst = max(worst, max_abs)
        grads_ok &= rel <= 1e-6 and max_abs <= 1e-5 * float(ref.abs().max())
        print(f"semi half, scale {s}: B4f relative L2 to plain {rel!r}, max abs {max_abs!r}",
              flush=True)
    equal = torch.equal(hist, plain)
    print(f"semi half {SEMI_HALF_SHAPE}: B3 over {tuple(e.shape)} rows, histogram bit-equal "
          f"to plain: {equal}", flush=True)
    if not (equal and grads_ok):
        raise AssertionError("B3/B4f disagree with their plain versions on the semi half")
    lg = scales[0]
    t = {"b3_ms": cuda_ms(lambda: bucket_histogram(e, fg)),
         "b3_plain_ms": cuda_ms(lambda: bucket_histogram_plain(e, fg), reps=5),
         "b4f_ms": cuda_ms(lambda: bucket_dlogits(e[:c], fg[:c], table[:c], lg,
                                                  per_image=False)),
         "b4f_plain_ms": cuda_ms(lambda: bucket_dlogits_plain(e[:c], fg[:c], table[:c],
                                                              lg, False), reps=5)}
    print(f"semi half timings (CUDA events): {t}", flush=True)
    return dict(t, b4f_max_abs=worst)


def _synthetic_moco(path, seed: int = 23) -> dict:
    """A MoCo-v2 style checkpoint of a seeded ResNet-50 (the query encoder
    under `module.encoder_q.`, its fc head, the queue) at `path`."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models.resnet import (
        ResNetBackbone)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        enc = ResNetBackbone("resnet50")
    sd = {f"module.encoder_q.{k}": v for k, v in enc.state_dict().items()}
    sd.update({"module.encoder_q.fc.0.weight": torch.zeros(2048, 2048),
               "module.encoder_q.fc.2.weight": torch.zeros(128, 2048),
               "module.queue": torch.zeros(128, 16)})
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": sd, "epoch": 800, "arch": "resnet50"},
               path / "moco_v2_800ep_pretrain.pth.tar")
    return enc.state_dict()


def phase23_semi(dev, data) -> dict:
    """The flagship with the SemiSupervisedLoss over its TwoScaleLoss
    (bucket Lovász, the generic route on each half) trained by
    `Trainer.train` for 2 epochs, the tree's left-out frames as the
    unlabelled pool: launches (B3 once a half and B4f once a scale a half
    each step, B1 once a validation batch), B3/B4f against their plain
    versions at the half-batch shape, the index streams, a resume, one
    step's pseudo-labels against an explicit teacher pass that leaves
    BatchNorm as it was, the semi step's time against the flagship's and
    the teacher's share, and a MoCo-initialised run."""
    import tempfile

    from miccai2021_cataract_semantic_segmentation_tpu_torch.data import (
        SegDataset, load_frame_table, split_dataframes)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import (
        assemble_batch)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import augment_batch
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        make_train_step, step_draws, teacher_labels)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer

    out = {"half": check_semi_half(dev)}
    base = json.loads(pathlib.Path(CONFIG).read_text())
    task, bs = int(base["data"]["experiment"]), int(base["data"]["batch_size"])
    half = bs // 2
    cfg = dict(base, loss={"name": "SemiSupervisedLoss", "labeled": base["loss"],
                           "pseudo_threshold": SEMI_THRESHOLD},
               train=dict(base["train"], epochs=2), log_every_n_epochs=1)
    table = load_frame_table(data_path=str(data))
    train_df, valid_df = split_dataframes(table, 2, blacklist=base["data"]["blacklist"])
    pool_df = table.select(np.isin(table["vid_num"], POOL_VIDEOS))
    sets = (SegDataset(train_df, task, str(data)), SegDataset(valid_df, task, str(data)),
            train_df, valid_df, SegDataset(pool_df, task, str(data)))
    n_valid_full = VALID_FRAMES // (8 if dev.type == "cuda" else 1)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_semi_"))
    logs = tmp / "logs"

    def run(run_id, epochs=2, **changes):
        trainer = Trainer(dict(cfg, log_path=str(logs), run_id=run_id,
                               train=dict(cfg["train"], epochs=2), **changes),
                          sets, device=dev)
        trainer.epochs = epochs
        return trainer

    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with _RunRecorder() as rec:
            a = run("semi_a")
            t = time.perf_counter()
            a.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches, peak = launch_counts(), torch.cuda.max_memory_allocated()
        rec.print_epochs()
        steps = len(rec.steps)
        print(f"semi run A: {steps} steps of batches "
              f"{sorted({s for _, s, _ in rec.steps})}, {wall!r} s wall in process, peak "
              f"memory {peak} bytes; labelled/unlabelled terms by step "
              f"{[(round(float(m['labeled']), 6), round(float(m['unlabeled']), 6)) for _, _, m in rec.steps]}",
              flush=True)
        _expect_launches(launches, {"bucket_hist": 2 * steps, "bucket_dlogits": 4 * steps,
                                    "fu_hist": 2 * n_valid_full}, "semi run A")
        out["launches"] = launches
        batches = np.concatenate([a.epoch_batches[e] for e in range(2)])
        n_lab = len(train_df)
        if not ((batches[:, :half] < n_lab).all() and (batches[:, half:] >= n_lab).all()
                and (batches[:, half:] < n_lab + len(pool_df)).all()
                and int(a.ind_counts.sum()) == half * steps == half * len(batches)):
            raise AssertionError("the semi batches are not [labelled | unlabelled]")
        # with random weights no pixel reaches the recipe's threshold, so the
        # pseudo-labelled term is 0 and its half all ignored
        if not all(np.isfinite(v) and v >= 0 for _, v in rec.step_values("unlabeled")):
            raise AssertionError("a pseudo-labelled term is not finite")

        # interrupted after epoch 0 and resumed from `last`
        b = run("semi_b", epochs=1)
        b.train()
        b.close()
        c = run("semi_b")
        c.load_checkpoint("last")
        c.train()
        c.close()
        apart = rel_l2(flat_floats(c.model.state_dict()), flat_floats(a.model.state_dict()))
        same = all(np.array_equal(c.epoch_batches[e], a.epoch_batches[e]) for e in range(2))
        print(f"semi resume: final weights relative L2 {apart!r} from run A; batches "
              f"equal {same}", flush=True)
        if not same:
            raise AssertionError("the resumed run's batches differ from run A's")
        if apart != 0:
            r = run("semi_repeat")
            r.train()
            r.close()
            spread = rel_l2(flat_floats(r.model.state_dict()), flat_floats(a.model.state_dict()))
            print(f"semi repeat of A: relative L2 {spread!r}", flush=True)
            if not 0 < apart <= 2 * spread:
                raise AssertionError(f"the resumed run lies {apart!r} from A, the "
                                     f"spread is {spread!r}")
        del b, c

        # one step's pseudo-labels against an explicit teacher pass, at the
        # recipe's threshold and at the median of the teacher's confidence
        spec = a.pipeline.device
        images, labels, _ = assemble_batch(a._iter_set, a.epoch_batches[0][0])
        images, labels = torch.as_tensor(images).to(dev), torch.as_tensor(labels).to(dev)
        draws = step_draws(spec, bs, a.seed, a.state.step)
        x, lbl = augment_batch(images, labels, spec, draws)
        x = x.permute(0, 3, 1, 2).contiguous()
        model = a.model

        def explicit_teacher():
            """The teacher's confidence and class a pixel, from an eval-mode
            forward under the step's precision (each step moves the weights)."""
            model.eval()
            with torch.no_grad(), torch.autocast(dev.type, dtype=torch.bfloat16,
                                                 enabled=a.precision == "bf16"):
                probs = torch.softmax(model(x[half:])["logits"].float(), dim=1)
            model.train()
            return probs.max(dim=1)

        median = float(explicit_teacher()[0].median())
        for threshold in (SEMI_THRESHOLD, median):
            scores, classes = explicit_teacher()
            want = torch.where(scores < threshold, a.num_classes, classes)
            buffers = {k: v.clone() for k, v in model.state_dict().items()
                       if "running" in k or "num_batches" in k}
            pseudo = teacher_labels(model, x[half:], a.precision, threshold, a.num_classes)
            kept = all(torch.equal(v, model.state_dict()[k]) for k, v in buffers.items())
            debug_step = make_train_step(
                a.loss_fn, spec, task, device=dev, precision=a.precision,
                train_metrics="s8", seed=a.seed, debug_pred=True,
                semi={"threshold": threshold, "ignore_id": a.num_classes})
            m = debug_step(a.state, images, labels, 0, draws)
            got = m["debug_lbl"].long()
            off = int((pseudo != want).sum())
            equal = (off == 0 and torch.equal(got[half:], pseudo)
                     and torch.equal(got[:half], lbl[:half]))
            share = float((want == a.num_classes).float().mean())
            print(f"explicit teacher pass at threshold {threshold!r}: {off} pseudo-labels "
                  f"of teacher_labels differ from its; the step's equal to both {equal} "
                  f"({share!r} of the pseudo pixels below it); "
                  f"BatchNorm buffers unchanged by the teacher {kept}; model in train "
                  f"mode {model.training}; the step's terms labelled "
                  f"{float(m['labeled'])!r}, unlabelled {float(m['unlabeled'])!r}",
                  flush=True)
            if not (equal and kept and model.training):
                raise AssertionError("the teacher pass and the step's pseudo-labels disagree")
        if not 0 < share < 1 or not float(m["unlabeled"]) > 0:
            raise AssertionError("at the median confidence the pseudo half is not mixed")

        # the semi step against the flagship's on one batch, and the teacher
        plain_step = make_train_step(build_loss(base["loss"], task, dev), spec, task,
                                     device=dev, precision=a.precision, train_metrics="s8",
                                     seed=a.seed)
        semi_step = make_train_step(a.loss_fn, spec, task, device=dev, precision=a.precision,
                                    train_metrics="s8", seed=a.seed,
                                    semi={"threshold": SEMI_THRESHOLD,
                                          "ignore_id": a.num_classes})
        lab_images, lab_labels, _ = assemble_batch(sets[0], np.arange(bs))
        lab_images = torch.as_tensor(lab_images).to(dev)
        lab_labels = torch.as_tensor(lab_labels).to(dev)
        # at the median the pseudo half is mixed, so B3/B4f and the loss count
        # its pixels, where at the recipe's threshold they are all ignored
        mixed_step = make_train_step(a.loss_fn, spec, task, device=dev,
                                     precision=a.precision, train_metrics="s8",
                                     seed=a.seed, semi={"threshold": median,
                                                        "ignore_id": a.num_classes})
        step_fns = {"plain": lambda: plain_step(a.state, lab_images, lab_labels, 0),
                    "semi": lambda: semi_step(a.state, images, labels, 0),
                    "semi_mixed": lambda: mixed_step(a.state, images, labels, 0)}
        timing = {}
        for name in ("plain", "semi", "semi_mixed", "semi_mixed", "semi", "plain"):
            timing.setdefault(name, []).append(cuda_ms(step_fns[name], 5, 1))
        teacher_ms = cuda_ms(lambda: teacher_labels(model, x[half:], a.precision,
                                                     SEMI_THRESHOLD, a.num_classes), 5, 1)
        mean = {k: statistics.mean(v) for k, v in timing.items()}
        print(f"train step (CUDA events, median of 5, in turns plain/semi/semi_mixed/"
              f"semi_mixed/semi/plain): semi at {SEMI_THRESHOLD} {timing['semi']} ms, "
              f"semi at the median {median!r} {timing['semi_mixed']} ms, flagship "
              f"{timing['plain']} ms; teacher pass {teacher_ms!r} ms = "
              f"{teacher_ms / mean['semi']!r} of the semi step at {SEMI_THRESHOLD}, "
              f"{teacher_ms / mean['semi_mixed']!r} at the median", flush=True)
        out.update(semi_ms=mean["semi"], semi_mixed_ms=mean["semi_mixed"],
                   plain_ms=mean["plain"], teacher_ms=teacher_ms, peak=peak)
        a.close()
        del a, model, debug_step, semi_step, mixed_step, plain_step

        # a MoCo-initialised run from a synthetic checkpoint
        moco = _synthetic_moco(tmp / "ss" / "moco")
        t = run("semi_moco", epochs=1, graph=dict(cfg["graph"], ss_pretrained="moco"),
                ss_pretrained_path=str(tmp / "ss"))
        sd = t.model.state_dict()
        copied = [k for k in moco if not k.endswith("num_batches_tracked")]
        if not all(torch.equal(sd[f"backbone.{k}"].cpu(), moco[k]) for k in copied):
            raise AssertionError("the MoCo tensors did not reach the backbone")
        metrics = t.train()
        t.close()
        print(f"MoCo-initialised run: {len(copied)} backbone tensors from the checkpoint; "
              f"validation {metrics['valid_loss']!r}, train loss "
              f"{t.train_metrics['loss']!r}", flush=True)
        if not np.isfinite(t.train_metrics["loss"]):
            raise AssertionError("the MoCo-initialised run's loss is not finite")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 24: the remaining graphs
# ---------------------------------------------------------------------------

POINTREND_GRAPH = {"model": "PointRend", "encoder": {"model": "ResNet50"}}
# kernel launches a validation batch and a train step: the fused routes run
# B1 (and B2 in the backward), the generic route B3 (and B4f)
FUSED_LAUNCHES = {"eval": {"fu_hist": 1}, "train": {"fu_hist": 1, "fu_grad": 1}}
GENERIC_LAUNCHES = {"eval": {"bucket_hist": 1},
                    "train": {"bucket_hist": 1, "bucket_dlogits": 1}}
# name: (graph, recipe, launches); recipe "flagship" is configs/OCRNet_rf_lvsz.json
# (its TwoScaleLoss, bucket Lovász at B 1024), "upernet" configs/UPN_rf_lvsz.json
# with UPN_LOSS (the LossWrapper's bucket Lovász: fused from `logits_s8_acf`,
# else generic on the full-resolution logits)
GRAPHS24 = {
    "OCRNet-R18": ({"model": "OCRNet", "backbone": "resnet18"}, "flagship", FUSED_LAUNCHES),
    "OCRNet-R34": ({"model": "OCRNet", "backbone": "resnet34"}, "flagship", FUSED_LAUNCHES),
    "OCRNet-HRNetW18": ({"model": "OCRNet", "backbone": "hrnetv2_w18"}, "flagship",
                        FUSED_LAUNCHES),
    "FCN": ({"model": "FCN"}, "upernet", GENERIC_LAUNCHES),
    "UNet": ({"model": "UNet"}, "upernet", GENERIC_LAUNCHES),
    "UPerNet-InceptionV3": ({"model": "EncDec", "encoder": {"model": "InceptionV3"},
                             "decoder": {"model": "UPerNet"}}, "upernet", FUSED_LAUNCHES),
    "UPerNet-ResNeXt50": ({"model": "UPerNet", "encoder": {"model": "ResNeXt50"}},
                          "upernet", FUSED_LAUNCHES),
    "UPerNet-WideResNet50": ({"model": "UPerNet", "encoder": {"model": "WideResNet50"}},
                             "upernet", FUSED_LAUNCHES),
}
# the narrow forward card vs CPU: every output of the eval forward at a
# 2 x 128 x 160 input, the card in float32 with TF32 off against the CPU in
# float64 from the same weights, relative L2 at most NARROW_TOL (float32
# sums over some fifty layers)
NARROW_HW = (128, 160)
NARROW_TOL = 1e-4
# PointRend's eval subdivision on the card against the CPU at one 272 x 480
# frame. End to end with the card in float32 (TF32 off): at most
# SELECT_DIFF_F32 of a step's 784 selected cells selected by one side
# alone, the coarse map within COARSE_TOL of its largest element, the
# refined values at the cells both select within REFINED_TOL of the
# largest. Under bf16 autocast (the validation precision) the coarse
# logits round to 8 bits and, at random weights, the uncertainties near
# the 784th are near-ties, so the two ends select other cells (0.49 and
# 0.70 of them on an H100 at 700 W, where a bound of 0.5 had been set
# beforehand); that share is printed, and each bf16 step is replayed on the
# CPU from the card's own input to it: the cells the CPU selects there
# differ by at most SELECT_DIFF_REPLAY (float32 upsample sums in another
# order can only reorder cells whose uncertainties tie within a
# rounding), and the card's values written at the card's cells on the CPU
# give the card's map, bit-equal at those cells and within COARSE_TOL of
# the largest element elsewhere
SELECT_DIFF_F32 = 0.01
SELECT_DIFF_REPLAY = 0.01
COARSE_TOL = 1e-4
REFINED_TOL = 1e-3
ENSEMBLE_MEMBERS = {"a_ocrnet_r50": ("flagship", {"model": "OCRNet", "backbone": "resnet50",
                                                  "out_stride": 8}),
                    "b_upernet_r34": ("upernet", None)}


def recipe24(recipe: str, graph: dict | None = None) -> dict:
    """A phase-24 recipe's run config with `graph` in place of its own."""
    cfg = json.loads(pathlib.Path(CONFIG).read_text()) if recipe == "flagship" \
        else upernet_config()
    return cfg if graph is None else dict(cfg, graph=graph)


def subdivision_trace(model, x: torch.Tensor, bf16: bool) -> dict:
    """PointRend's eval forward step by step with the decoder's own
    functions: the coarse map, and for each subdivision step its input
    map, the cells it selects, their new values and its output map (the
    last is the forward's `logits`), all on the CPU in float32."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import pointrend as pr
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear
    dec = model.dec_model
    with torch.inference_mode(), torch.autocast(x.device.type, dtype=torch.bfloat16,
                                                enabled=bf16):
        feats = model.enc_model(x)
        conv_out = [feats[f"layer{i}"] for i in (1, 2, 3, 4)]
        _, coarse = dec.partial_upernet(conv_out, full_res=False)
        seg, steps = coarse, []
        for _ in range(dec.scale.bit_length() - 1):
            before = seg
            seg = resize_bilinear(seg, (2 * seg.shape[2], 2 * seg.shape[3]),
                                  align_corners=False)
            idx, coords = pr.uncertain_points_on_grid(seg, dec.subdivision_num_points)
            vals = dec._refine(conv_out, seg, coords)
            seg = pr.scatter_points(seg, idx, vals)
            steps.append({"before": before.float().cpu(), "idx": idx.cpu(),
                          "vals": vals.to(seg.dtype).float().cpu(),
                          "after": seg.float().cpu()})
        full = model(x)["logits"]
    if not torch.equal(full.float().cpu(), steps[-1]["after"]):
        raise AssertionError("the traced subdivision is not the forward's")
    return {"coarse": coarse.float().cpu(), "steps": steps}


def selection_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of (B, P) selected cells `a` that `b` does not select."""
    n, p = a.shape
    return sum(p - len(np.intersect1d(a[i].numpy(), b[i].numpy()))
               for i in range(n)) / (n * p)


def replay_step(step: dict, num_points: int) -> tuple[float, bool, float]:
    """One card subdivision step replayed on the CPU from the card's input
    map: the share of selected cells that differ, whether the card's values
    written at the card's cells give the card's map there bit for bit, and
    the largest difference elsewhere (of the largest element)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import pointrend as pr
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.resize import resize_bilinear
    before = step["before"]
    up = resize_bilinear(before, (2 * before.shape[2], 2 * before.shape[3]),
                         align_corners=False)
    idx, _ = pr.uncertain_points_on_grid(up, num_points)
    out = pr.scatter_points(up, step["idx"], step["vals"])
    n, c = out.shape[:2]
    at = step["idx"][:, None].expand(n, c, -1)
    flat_out, flat_card = out.flatten(2), step["after"].flatten(2)
    written = torch.equal(flat_out.gather(2, at), flat_card.gather(2, at))
    rest = float((out - step["after"]).abs().max()) / float(step["after"].abs().max())
    return selection_diff(step["idx"], idx), written, rest


def pointrend_card_vs_cpu(dev) -> dict:
    """The eval subdivision of a seed-0 PointRend-R50 on one 272 x 480
    frame: the card in float32 (TF32 off) against the CPU in float32 end
    to end (the coarse map, the cells each step selects by JAX's rule, the
    refined values where both select); the card in bf16 against the CPU
    end to end (printed), and each bf16 step replayed on the CPU from the
    card's input to it (gated)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        EvalSpec, eval_preprocess)
    images, _ = synthetic_set(1, 272, 480, seed=24)
    x = eval_preprocess(torch.as_tensor(images), EvalSpec(normalise=True))
    model = build_model(POINTREND_GRAPH, 2, device="cpu", seed=0)
    ref = subdivision_trace(model, x, False)
    model.to(dev)
    num_points = model.dec_model.subdivision_num_points
    tf32 = torch.backends.cudnn.allow_tf32
    out, failed = {}, []
    try:
        torch.backends.cudnn.allow_tf32 = False
        for bf16 in (False, True):
            got = subdivision_trace(model, x.to(dev), bf16)
            what = "bf16" if bf16 else "float32"
            scale = float(ref["coarse"].abs().max())
            coarse_err = float((got["coarse"] - ref["coarse"]).abs().max()) / scale
            diffs, refined = [], []
            for g, r in zip(got["steps"], ref["steps"]):
                diffs.append(selection_diff(g["idx"], r["idx"]))
                flat_g, flat_r = g["after"].flatten(2), r["after"].flatten(2)
                err = 0.0
                for b in range(g["idx"].shape[0]):
                    both = torch.as_tensor(np.intersect1d(g["idx"][b].numpy(),
                                                          r["idx"][b].numpy()))
                    err = max(err, float((flat_g[b][:, both] - flat_r[b][:, both])
                                         .abs().max()))
                refined.append(err / float(r["after"].abs().max()))
            print(f"PointRend subdivision card ({what}) vs CPU (float32), end to end: "
                  f"coarse map max difference {coarse_err!r} of its largest element; "
                  f"selected cells differing per step {diffs}; refined values at the "
                  f"cells both select, max difference {refined} of the largest",
                  flush=True)
            out[what] = {"coarse": coarse_err, "select_diff": diffs, "refined": refined}
            if not bf16:
                if (max(diffs) > SELECT_DIFF_F32 or max(refined) > REFINED_TOL
                        or coarse_err > COARSE_TOL):
                    failed.append(what)
                continue
            replays = [replay_step(step, num_points) for step in got["steps"]]
            print(f"PointRend bf16 steps replayed on the CPU from the card's input: "
                  f"(selected cells differing, the card's values written bit-equal, "
                  f"largest difference elsewhere) per step {replays}", flush=True)
            out["bf16_replay"] = replays
            if not all(d <= SELECT_DIFF_REPLAY and w and rest <= COARSE_TOL
                       for d, w, rest in replays):
                failed.append("bf16 replay")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    if failed:
        raise AssertionError(f"PointRend's subdivision card vs CPU fails in {failed}")
    return out


def narrow_card_vs_cpu(dev, name: str, graph: dict) -> float:
    """`graph`'s seed-0 eval forward at NARROW_HW, the card in float32 (TF32
    off) against the CPU in float64: the largest relative L2 over its
    outputs, at most NARROW_TOL."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    model = build_model(graph, 2, device="cpu", seed=0)
    x = torch.rand(2, 3, *NARROW_HW, generator=torch.Generator().manual_seed(24))
    with torch.inference_mode():
        want = model.double()(x.double())
        want = want if isinstance(want, dict) else {"out": want}
        model.float().to(dev)
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            got = model(x.to(dev))
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        got = got if isinstance(got, dict) else {"out": got}
    errs = {k: rel_l2(got[k].cpu(), want[k]) for k in want}
    print(f"{name} narrow forward card (float32, TF32 off) vs CPU (float64) at "
          f"2x{NARROW_HW[0]}x{NARROW_HW[1]}: relative L2 {errs}", flush=True)
    if set(got) != set(want) or not max(errs.values()) <= NARROW_TOL:
        raise AssertionError(f"{name}: card and CPU forwards disagree: {errs}")
    return max(errs.values())


def run_graph24(dev, name: str, graph: dict, recipe: str, expect: dict,
                images, labels) -> dict:
    """`validate` of one batch of 8 and `train_steps` of two, at full width,
    with the kernels' launches read around each, the train step's time and
    peak memory, and the narrow forward card vs CPU."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.augment import pad_reflect_hw
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
        has_point_head, train_metrics_source, train_steps)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import validate

    t0 = time.perf_counter()
    cfg, bs = recipe24(recipe, graph), 8
    model = build_model(graph, 2, device=dev, seed=0)
    n_params = sum(p.numel() for p in model.parameters())

    def expected(per, n):
        return dict(dict.fromkeys(KERNELS, 0), **{k: v * n for k, v in per.items()})

    reset_launches()
    res = validate(model, cfg, images[:bs], labels[:bs], device=dev, batch_size=bs)
    torch.cuda.synchronize()
    val_launches = launch_counts()
    n_counted = int((pad_reflect_hw(torch.as_tensor(labels[:bs])) < 17).sum())
    cm_total = int(res["confusion_matrix"].sum())
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    tr = train_steps(model, cfg, images, labels,
                     list(np.arange(2 * bs).reshape(2, bs)), device=dev)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step = make_train_step(build_loss(cfg["loss"], 2, dev),
                           device_spec(cfg["data"]["transforms"]), 2, device=dev,
                           precision=cfg.get("precision", "bf16"),
                           train_metrics=train_metrics_source(cfg),
                           has_point_head=has_point_head(graph))
    step_ms = cuda_ms(lambda: step(tr["state"], images[:bs], labels[:bs], 0),
                      reps=5, warmup=1)
    print(f"{name} ({recipe} recipe, {n_params} parameters): validate "
          f"{json.dumps({k: res[k] for k in ('valid_loss', 'miou')})}, cm total "
          f"{cm_total} of {n_counted}, launches {val_launches}; train_steps losses "
          f"{tr['step_losses']}, launches {launches}, peak memory {peak} bytes; "
          f"train step {step_ms!r} ms (CUDA events, median of 5) = "
          f"{bs / step_ms * 1e3!r} frames/s", flush=True)
    if val_launches != expected(expect["eval"], 1):
        raise AssertionError(f"{name} validate launched {val_launches}, expected "
                             f"{expect['eval']}")
    if launches != expected(expect["train"], 2):
        raise AssertionError(f"{name} train_steps launched {launches}, expected "
                             f"{expect['train']} a step")
    if not (np.isfinite(res["valid_loss"]) and cm_total == n_counted
            and np.isfinite(tr["step_losses"]).all()):
        raise AssertionError(f"{name}: validate or train_steps gave {res['valid_loss']}, "
                             f"cm {cm_total} of {n_counted}, {tr['step_losses']}")
    del model, tr, step
    torch.cuda.empty_cache()
    narrow = narrow_card_vs_cpu(dev, name, graph)
    return {"validate_launches": val_launches, "train_launches": launches,
            "step_ms": step_ms, "peak_bytes": peak, "narrow_rel_l2": narrow,
            "seconds": time.perf_counter() - t0}


def generic_c18(dev) -> None:
    """B3 and B4f at UNet's 18 logit channels (8 x 544 x 960, the ignore
    channel kept): B3's histogram bit-equal to its plain version, B4f
    within one bf16 ulp of its plain version, and the B4f instance that
    runs (its class array and block)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        bucket_dlogits, bucket_dlogits_plain, bucket_histogram, bucket_histogram_plain)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import bucket_grad
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.bucket_lovasz import (
        grad_table, losses_and_tables)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses.functional import (
        lovasz_rows)
    n, h, w = B3_CELL
    gen = torch.Generator(device=dev).manual_seed(18)
    logits = (3.0 * torch.randn((n, 18, h, w), generator=gen, device=dev)).bfloat16()
    labels = torch.as_tensor(blocky_labels(np.random.default_rng(18), n, h, w, 18, 8),
                             device=dev)
    e, fg, present = lovasz_rows(logits, labels)
    e, fg = e.contiguous(), fg.contiguous()
    hist = bucket_histogram(e, fg)
    hist_equal = bool(torch.equal(hist, bucket_histogram_plain(e, fg)))
    _, _, g_fg, g_bg = losses_and_tables(hist)
    table = grad_table(g_fg, g_bg, loss_cotangent(present, n, False))
    got = bucket_dlogits(e, fg, table, logits)
    ref = bucket_dlogits_plain(e, fg, table, logits, False)
    torch.cuda.synchronize()
    ulps = float(((got.float() - ref.float()).abs() / bf16_ulp(ref)).max())
    layout = bucket_grad.b4f_layout(18)
    print(f"B3/B4f at C 18 ({n}x{h}x{w}, bf16): B3 histogram bit-equal to plain "
          f"{hist_equal}; B4f within {ulps!r} bf16 ulps of plain; B4f instance: class "
          f"array {bucket_grad.fused_instance_maxc(18)}, {layout.threads} threads a "
          f"block, {layout.smem} bytes of tables in shared memory", flush=True)
    if not (hist_equal and ulps <= 1.0):
        raise AssertionError("B3/B4f at C 18 disagree with their plain versions")


def discriminator24(dev) -> dict:
    """SimpleDiscriminator (d 64, 544 x 960) forward and backward at batch 8
    on the card, bf16 autocast, and its narrow forward card vs CPU."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    model = build_model({"model": "SimpleDiscriminator"}, 2, device=dev, seed=0).train()
    x = torch.rand(8, 3, 544, 960, device=dev)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        with torch.autocast(dev.type, dtype=torch.bfloat16):
            y = model(x)
        y.float().sum().backward()
        return y.detach()

    y = fwd_bwd()
    torch.cuda.synchronize()
    grads = torch.cat([p.grad.reshape(-1).float() for p in model.parameters()])
    ms = cuda_ms(fwd_bwd, reps=5, warmup=1)
    print(f"SimpleDiscriminator: output {tuple(y.shape)} in [{float(y.min())!r}, "
          f"{float(y.max())!r}], gradient norm {float(grads.norm())!r}; forward and "
          f"backward {ms!r} ms (CUDA events, median of 5)", flush=True)
    if not (y.shape == (8, 1) and bool(((y > 0) & (y < 1)).all())
            and bool(torch.isfinite(grads).all())):
        raise AssertionError("SimpleDiscriminator's forward or backward failed")
    narrow = narrow_card_vs_cpu(dev, "SimpleDiscriminator",
                                {"model": "SimpleDiscriminator", "input_hw": NARROW_HW})
    return {"ms": ms, "narrow_rel_l2": narrow}


def ensemble24(dev, data, tmp) -> dict:
    """Two members (OCRNet-R50 on the flagship recipe, UPerNet-R34 on the
    UPerNet cell's), each trained one step and saved as its run's
    chkpt_best.pt; the Ensemble through the CLI in inference mode with mean
    and with max merge, each matrix and mIoU equal to the functional
    `ensemble_apply` on the same batches (cuDNN deterministic around both)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch import main as port_main
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data import (
        SegDataset, load_frame_table, split_dataframes)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import (
        assemble_batch, eval_batches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import (
        build_ensemble, build_model, ensemble_apply)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import (
        confusion_matrix, mean_iou_breakdown)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        EvalSpec, eval_preprocess)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import train_steps

    logs = tmp / "logs"
    images, labels = synthetic_set(8)
    members = {}
    for key, (recipe, graph) in ENSEMBLE_MEMBERS.items():
        cfg = recipe24(recipe, graph)
        model = build_model(cfg["graph"], 2, device=dev, seed=0)
        train_steps(model, cfg, images, labels, [np.arange(8)], device=dev)
        ckpt.save_checkpoint(logs / f"run_{key}" / "chkpts", "best", model, 0, 0.0, 0.0)
        members[key] = dict(cfg["graph"], ckpt=f"run_{key}")
        del model
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    out = {}
    try:
        for merge in ("mean", "max"):
            cfg = {"name": "ensemble", "mode": "inference", "manager": "Ensemble",
                   "graph": {"model": "Ensemble", "members": members, "merge": merge},
                   "data": {"experiment": 2, "split": 2, "transforms": ["pad"],
                            "blacklist": False, "batch_size": 8},
                   "train": {}, "loss": {}, "seed": 0, "run_id": f"ensemble_{merge}",
                   "data_path": str(data), "log_path": str(logs)}
            path = tmp / f"ensemble_{merge}.json"
            path.write_text(json.dumps(cfg))
            t = time.perf_counter()
            res = port_main.main(["-c", str(path), "-dp", str(data)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            valid_set = SegDataset(split_dataframes(
                load_frame_table(data_path=str(data)), 2, mode="inference",
                blacklist=False)[1], 2, str(data))
            bs = 8 if dev.type == "cuda" else 1            # the Trainer's valid batch
            ens = build_ensemble(cfg["graph"], 2, logs, dev)
            batches, n_pad = eval_batches(len(valid_set), bs)
            cm = torch.zeros((17, 17), dtype=torch.int64)
            for bi, idx in enumerate(batches):
                imgs, lbls, _ = assemble_batch(valid_set, idx)
                lbls = np.array(lbls)
                if n_pad and bi == len(batches) - 1:
                    lbls[bs - n_pad:] = 255
                x, lbl = eval_preprocess(torch.as_tensor(imgs).to(dev), EvalSpec(pad=True),
                                         torch.as_tensor(lbls).to(dev))
                with torch.inference_mode(), torch.autocast(dev.type, dtype=torch.bfloat16):
                    probs = ensemble_apply(list(zip(ens.members, ens.needs_norm)), x, merge)
                cm += confusion_matrix(probs, lbl, 17).cpu()
            miou = float(mean_iou_breakdown(cm.numpy(), 2)["miou"])
            same = np.array_equal(np.asarray(res["confusion_matrix"]), cm.numpy())
            print(f"Ensemble ({merge}) through the CLI: mIoU {res['miou']!r}, "
                  f"{res['frames_per_sec']!r} frames/s over {len(valid_set)} frames, "
                  f"{wall!r} s wall; the functional ensemble_apply: mIoU {miou!r}; "
                  f"matrices equal {same}", flush=True)
            if not (same and miou == res["miou"] and int(cm.sum()) > 0):
                raise AssertionError(f"the Ensemble ({merge}) through the CLI and "
                                     "ensemble_apply disagree")
            out[merge] = {"miou": miou, "frames_per_sec": res["frames_per_sec"]}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def phase24_remaining_graphs(dev, data) -> dict:
    """(a) EncDec-PointRend-R50 trained through the CLI for 2 epochs on the
    flagship recipe with the UPerNet cell's LossWrapper (bucket Lovász: the
    generic route, no stride-8 logits), its launches counted (one B3 a
    train step and a validation batch, one B4f a step), `point_loss` in
    every step's scalars, two subdivision steps a validation forward; the
    subdivision card vs CPU; the PointRend and UPerNet-R50 train and eval
    steps timed in turns, the PointRend step profiled; (b) each other graph
    of GRAPHS24 through `validate` and `train_steps` at full width; B3/B4f
    at UNet's C 18; the discriminator; (c) the Ensemble through the CLI.
    Returns the launch counts."""
    import tempfile

    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import pointrend as pr
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (
        create_train_state)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        make_eval_step, make_train_step)

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_graphs_"))
    out: dict = {"graphs": {}}
    try:
        # (a) PointRend through the CLI, its subdivisions counted
        t = time.perf_counter()
        cfg = recipe24("flagship", POINTREND_GRAPH)
        cfg = dict(cfg, loss=dict(UPN_LOSS), train=dict(cfg["train"], epochs=2))
        calls = []
        select = pr.uncertain_points_on_grid

        def counted(*args, **kwargs):
            calls.append(1)
            return select(*args, **kwargs)

        pr.uncertain_points_on_grid = counted
        try:
            rec, launches, wall, peak = _cli_run(data, tmp / "logs", tmp, "pointrend",
                                                 cfg, dev)
        finally:
            pr.uncertain_points_on_grid = select
        n_steps = len(rec.steps)
        point_losses = rec.step_values("point_loss")
        n_valid = VALID_FRAMES // (8 if dev.type == "cuda" else 1)   # the Trainer's batch
        print(f"PointRend through the CLI: {n_steps} steps, point_loss per step "
              f"{point_losses}, {len(calls)} subdivision steps, {wall!r} s wall, peak "
              f"memory {peak} bytes", flush=True)
        _expect_launches(launches, {"bucket_hist": n_steps + 2 * n_valid,
                                    "bucket_dlogits": n_steps}, "PointRend through the CLI")
        if not (n_steps > 0 and len(point_losses) == n_steps
                and all(np.isfinite(v) and v > 0 for _, v in point_losses)
                and len(calls) == 2 * 2 * n_valid):
            raise AssertionError("PointRend's point loss or its subdivisions are missing")
        out["pointrend"] = {"launches": launches, "steps": n_steps,
                            "seconds": time.perf_counter() - t}
        out["pointrend"]["card_vs_cpu"] = pointrend_card_vs_cpu(dev)

        # PointRend's and UPerNet-R50's train and eval steps, in turns
        images, labels = synthetic_set(16)
        steps, evals = {}, {}
        for name, graph in (("PointRend", POINTREND_GRAPH),
                            ("UPerNet", {"model": "UPerNet",
                                         "encoder": {"model": "ResNet50"}})):
            model = build_model(graph, 2, device=dev, seed=0)
            state = create_train_state(model, cfg["train"], lambda step: 1e-4)
            loss_fn = build_loss(UPN_LOSS, 2, dev)
            steps[name] = (state, make_train_step(
                loss_fn, device_spec(cfg["data"]["transforms"]), 2, device=dev,
                train_metrics="s8", has_point_head=name == "PointRend"))
            evals[name] = (model, make_eval_step(None, 17, dev))
        times = {"train": {}, "eval": {}}
        for name in ("PointRend", "UPerNet", "UPerNet", "PointRend"):
            state, step = steps[name]
            times["train"].setdefault(name, []).append(cuda_ms(
                lambda: step(state, images[:8], labels[:8], 0), reps=5, warmup=1))
            model, ev = evals[name]
            times["eval"].setdefault(name, []).append(cuda_ms(
                lambda: ev(model, images[:8], labels[:8]), reps=5, warmup=1))
        print(f"PointRend-R50 and UPerNet-R50 steps at batch 8, in turns (CUDA events, "
              f"medians of 5; train on the LossWrapper, eval without a loss): "
              f"{json.dumps(times)}", flush=True)
        state, step = steps["PointRend"]
        groups = profile_step(lambda: step(state, images[:8], labels[:8], 0),
                              "PointRend train")
        out["pointrend"].update(times=times, profile=groups)
        del steps, evals, state, step
        torch.cuda.empty_cache()

        # (b) the other graphs
        for name, (graph, recipe, expect) in GRAPHS24.items():
            out["graphs"][name] = run_graph24(dev, name, graph, recipe, expect,
                                              images, labels)
            torch.cuda.empty_cache()
        generic_c18(dev)
        out["discriminator"] = discriminator24(dev)

        # (c) the Ensemble
        out["ensemble"] = ensemble24(dev, data, tmp)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 25: the served extras: TTA, video inference, the serving export and
# the semi mode's pool of the training videos
# ---------------------------------------------------------------------------

VIDEO_HW = (540, 960)
VIDEO_FRAMES = (13, 11)
POOL_TRAIN_VIDEOS = (1, 3)           # split 2's first training videos
TTA_CPU_HW = (136, 240)              # the reduced frame of TTA card vs CPU
TTA_CPU_TOL = 1e-4                   # largest |probability| difference, f32 vs f64
EXPORT_PRED_SHARE = 1e-3             # share of pixels whose class may differ
EXPORT_CONF_TOL = 5e-3               # largest |confidence| difference (bf16 steps)
# (mode, demo_frame_freq, decode workers, cv2 hidden from data/video_io.py)
VIDEO_RUNS = (("video_inference", 1, 1, True), ("video_inference", 2, 4, True),
              ("demo_video_inference", 1, 4, True), ("demo_video_inference", 2, 1, True),
              ("demo_video_inference", 1, 4, False))

_SERVE_ALONE = """
import json, os, statistics, sys, time
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax",
                                  "miccai2021_cataract_semantic_segmentation_tpu",
                                  "miccai2021_cataract_semantic_segmentation_tpu_torch"):
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, Block())
import numpy as np
import torch


def wait_for(path):
    deadline = time.perf_counter() + 900
    while not os.path.exists(path):
        if time.perf_counter() > deadline:
            sys.exit("no " + path)
        time.sleep(0.1)


def timed(fn):
    if dev.type != "cuda":
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


# device ms a call (kernels and copies, torch.profiler) and the device
# operations a call launches
def device_busy(fn, calls=3):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False) or "#" in ev.key):
            continue
        t = getattr(ev, "self_device_time_total", None)
        us += ev.self_cuda_time_total if t is None else t
        n += ev.count
    return us / 1e3 / calls, n // calls


# calls a batch: warm-up, then timed (CUDA events; batch 1 spreads the most)
WARM, TIMED = 2, {1: 20, 8: 10}
dev = torch.device(sys.argv[1])
frames = torch.from_numpy(np.load(sys.argv[2])).to(dev)
paths = sys.argv[3:]
programs, out = {}, {}
for path in paths:          # each loads once the exporting process marks it ready
    wait_for(path + ".ready")
    t = time.perf_counter()
    programs[path] = torch.export.load(path).module()
    out[path] = {"load_s": time.perf_counter() - t}
wait_for(sys.argv[2] + ".exports_done")   # served with the host to itself

for path in paths:
    res = {}
    with torch.no_grad():
        for b in (1, 8):
            x = frames[:b].contiguous()
            for _ in range(WARM):
                got = programs[path](x)
            times = [timed(lambda: programs[path](x)) for _ in range(TIMED[b])]
            q1, median, q3 = statistics.quantiles(times, n=4)
            rec = {"median": median, "q1": q1, "q3": q3, "min": min(times),
                   "max": max(times), "calls": TIMED[b]}
            if b == 1 and dev.type == "cuda":
                rec["busy_ms"], rec["device_ops"] = device_busy(lambda: programs[path](x))
                rec["busy_share"] = rec["busy_ms"] / rec["median"]
            res[b] = (got["pred"].cpu().numpy(), got["confidence"].cpu().numpy(), rec)
    np.savez(path + ".served.npz", pred1=res[1][0], conf1=res[1][1],
             pred8=res[8][0], conf8=res[8][1])
    out[path].update(ms_b1=res[1][2]["median"], ms_b8=res[8][2]["median"],
                     serve_b1=res[1][2], serve_b8=res[8][2])
print(json.dumps({"served": out, "port_modules": sorted(
    m for m in sys.modules if m.startswith("miccai"))}))
"""


def _write_video(path, images) -> None:
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data import video_io
    writer = video_io.AviWriter(path, 25, (images.shape[2], images.shape[1]))
    for f in images:
        writer.write(f)
    writer.release()


def tta_card_vs_cpu(dev, model, spec) -> float:
    """TTA's merged probabilities of one reduced frame on the card (float32,
    TF32 off) against the CPU in float64; the largest difference."""
    import copy

    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        TTA_SCALES, _forward, eval_preprocess, tta_merged_probs)
    images, _ = train_from_disk_set(*TTA_CPU_HW, seed=5, block=17)
    x = eval_preprocess(torch.as_tensor(images[:1]), spec)
    cpu = copy.deepcopy(model).cpu().double().eval()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            got = tta_merged_probs(lambda xi: _forward(model, xi, "f32")["logits"],
                                   x.to(dev), TTA_SCALES).double().cpu()
            want = tta_merged_probs(lambda xi: _forward(cpu, xi, "f64")["logits"],
                                    x.double(), TTA_SCALES)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    diff = float((got - want).abs().max())
    print(f"TTA card (float32, TF32 off) vs CPU (float64) at one {TTA_CPU_HW} frame: "
          f"largest probability difference {diff!r} (gate {TTA_CPU_TOL}); argmax "
          f"differs on {int((got.argmax(1) != want.argmax(1)).sum())} of "
          f"{want[:, 0].numel()} pixels", flush=True)
    if not diff <= TTA_CPU_TOL:
        raise AssertionError(f"TTA card vs CPU {diff} > {TTA_CPU_TOL}")
    return diff


def tta_device_rate(dev, trainer) -> dict:
    """The TTA step and the eval step alone on one batch of 8 validation
    frames already on the card (CUDA events), and one TTA step under the
    profiler: the device's rate, its busy share and where its time goes."""
    frames = np.stack([trainer.valid_set[i][0] for i in range(8)])
    x = torch.as_tensor(frames).to(dev)
    lbl = torch.zeros(x.shape[:3], dtype=torch.uint8, device=dev)
    tta_step = trainer._make_tta_step()
    tta_ms = cuda_ms(lambda: tta_step(trainer.model, x, lbl), reps=3, warmup=1)
    eval_ms = cuda_ms(lambda: trainer.eval_step(trainer.model, x, lbl), reps=10)
    groups = profile_step(lambda: tta_step(trainer.model, x, lbl), "TTA batch 8", steps=1)
    busy_ms = sum(groups.values())
    rec = {"tta_step_ms": tta_ms, "tta_device_frames_per_sec": 8e3 / tta_ms,
           "eval_step_ms": eval_ms, "eval_device_frames_per_sec": 8e3 / eval_ms,
           "tta_over_eval": tta_ms / eval_ms, "tta_busy_ms": busy_ms,
           "tta_busy_share": busy_ms / tta_ms}
    print(f"TTA step alone at batch 8 on the card: {json.dumps(rec)} (CUDA events, "
          f"median of 3; the eval step median of 10; busy from one profiled step)",
          flush=True)
    return rec


def _expected_video(trainer, paths, freq, side) -> dict:
    """{output name: frames}: the colormap of the in-process eval step's
    argmax over demo_infer's chunks (batch 8, the tail padded)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import VideoDataset
    from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.remap import mask_to_colormap
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.video import _chunks
    h, w = VIDEO_HW
    ds = VideoDataset(paths, h, w)
    indices = np.concatenate([np.arange(ds.offsets[v], ds.offsets[v + 1], freq)
                              for v in range(len(paths))])
    out = {f"{pathlib.Path(p).stem}_OCRNet.avi": [] for p in paths}
    names = list(out)
    dummy = np.zeros((8, h, w), np.uint8)
    for chunk, n_valid in _chunks(indices, 8):
        items = [ds[int(j)] for j in chunk]
        frames = np.stack([f for f, _, _ in items])
        logits, _, _ = trainer.eval_step(trainer.model, frames, dummy)
        preds = logits.argmax(1).to(torch.uint8).cpu().numpy()
        off = (preds.shape[1] - h) // 2
        preds = preds[:, off:off + h]
        for k in range(n_valid):
            colour = mask_to_colormap(preds[k], 2)
            img = np.concatenate([frames[k], colour], axis=1) if side else colour
            out[names[items[k][2]]].append(img)
    return out


def phase25_served_extras(dev, data) -> dict:
    """(a) TTA through the CLI (`"tta": true`, valid batch 8) on
    OCRNet-R50 t2, its matrix equal to the in-process `infer(tta=True)`'s,
    no kernel launched, frames/s and peak memory, the TTA step's rate on
    the card alone (`tta_device_rate`), and card vs CPU at one reduced
    frame; (b) two 540x960 videos written by the port's AVI writer
    through both video modes of the CLI, `demo_frame_freq` 1 and 2, decode
    workers 1 and 4, each output read back by the port's reader equal to
    the colormap of the in-process eval step's argmax; (c) `export_trainer`
    of OCRNet-R50 t2, its TTA variant and an Ensemble, each `.pt2` served
    at batch 1 and 8 in a process that blocks the port package, against
    the Trainer's steps, the serve ms with their spread and the batch-1
    call's device time; (d) the flagship semi recipe with no given pool,
    its pool the training split's videos in the port's AVI: `Trainer.train`
    for one epoch, the pool's length and the launches. Returns the
    measurements, (d)'s launches among them, and each part's wall s."""
    import tempfile

    from miccai2021_cataract_semantic_segmentation_tpu_torch import main as port_main
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data import video_io
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import VideoDataset
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.semi import (
        excluded_frames_from_df, video_files_from_split)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train import export
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.checkpoint import (
        save_checkpoint)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import parse_config
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_extras_"))
    logs = tmp / "logs"
    out: dict = {"part_s": {}}
    t_part = [time.perf_counter()]

    def lap(part: str) -> None:
        now = time.perf_counter()
        out["part_s"][part] = now - t_part[0]
        print(f"phase 25{part} took {now - t_part[0]!r} s wall", flush=True)
        t_part[0] = now

    try:
        model = build_model({"model": "OCRNet", "backbone": "resnet50", "out_stride": 8},
                            2, device=dev, seed=0)
        save_checkpoint(logs / "published_t2" / "chkpts", "best", model, 0, 0.0, 0.0)
        base = dict(parse_config(os.path.join(ROOT, "configs", PRETRAINED[1])),
                    data_path=str(data), log_path=str(logs),
                    load_checkpoint="published_t2", valid_batch_size=8)

        # (a) TTA through the CLI and in process
        cfg_path = tmp / "tta.json"
        cfg_path.write_text(json.dumps(dict(base, tta=True, run_id="tta_cli")))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t = time.perf_counter()
        cli = port_main.main(["-c", str(cfg_path), "-dp", str(data)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches, peak = launch_counts(), torch.cuda.max_memory_allocated()
        trainer = Trainer(dict(base, run_id="tta_inproc"), device=dev)
        trainer.load_checkpoint("best", run_id="published_t2")
        inproc = trainer.infer(tta=True)
        same = cli["confusion_matrix"] == inproc["confusion_matrix"]
        n_px = int(np.asarray(cli["confusion_matrix"]).sum())
        print(f"TTA through the CLI (OCRNet-R50 t2, valid batch 8, scales 0.75-2.0 x "
              f"flip): {cli['frames_per_sec']!r} frames/s (host clock, warm-up "
              f"excluded), {wall!r} s wall, peak memory {peak} bytes, miou "
              f"{cli['miou']!r}, {n_px} pixels; in process {inproc['frames_per_sec']!r} "
              f"frames/s; matrices equal {same}", flush=True)
        _expect_launches(launches, {}, "TTA through the CLI")
        if not (same and cli["tta"] and n_px > 0):
            raise AssertionError("TTA through the CLI and in process disagree")
        out["tta"] = {"frames_per_sec": cli["frames_per_sec"], "peak_bytes": peak,
                      "card_vs_cpu": tta_card_vs_cpu(dev, trainer.model, trainer.eval_spec)}
        out["tta"].update(tta_device_rate(dev, trainer))

        lap("a")

        # (b) video inference through the CLI
        images, _ = train_from_disk_set(*VIDEO_HW, seed=2)
        cadis = tmp / "cadis"
        shutil.copytree(data, cadis / "data")
        vdir = cadis / "workflow" / "test" / "videos"
        vdir.mkdir(parents=True)
        clips = np.split(images[:sum(VIDEO_FRAMES)], [VIDEO_FRAMES[0]])
        paths = [vdir / f"dev{k + 1:02d}.mp4" for k in range(2)]
        t = time.perf_counter()
        for path, clip in zip(paths, clips):
            _write_video(path, clip)
        write_s = time.perf_counter() - t
        reader = video_io.open_reader(paths[0])
        read_t = time.perf_counter()
        for i in range(reader.frame_count):
            reader.read(i)
        read_ms = (time.perf_counter() - read_t) * 1e3 / reader.frame_count
        print(f"videos: {VIDEO_FRAMES} frames of {VIDEO_HW} written by the port's AVI "
              f"writer in {write_s!r} s ({sum(p.stat().st_size for p in paths)} bytes); "
              f"the port's reader {read_ms!r} ms a frame", flush=True)
        expected = {}
        video_base = dict(base, data_path=str(cadis / "data"),
                          video_ids=[p.stem for p in paths], video_height=VIDEO_HW[0],
                          video_width=VIDEO_HW[1])
        out["video"] = []
        installed_cv2 = video_io.cv2
        for mode, freq, workers, hide_cv2 in VIDEO_RUNS:
            run = f"{mode}_f{freq}_w{workers}" + ("" if hide_cv2 else "_as_installed")
            cfg = dict(video_base, mode=mode, run_id=run, demo_frame_freq=freq,
                       video_decode_workers=workers)
            (tmp / f"{run}.json").write_text(json.dumps(cfg))
            reset_launches()
            # the port's own AVI, lossless, where cv2 would write XVID
            video_io.cv2 = None if hide_cv2 else installed_cv2
            t = time.perf_counter()
            try:
                res = port_main.main(["-c", str(tmp / f"{run}.json"), "-dp",
                                      str(cadis / "data")])
            finally:
                video_io.cv2 = installed_cv2
            wall = time.perf_counter() - t
            side = mode == "demo_video_inference"
            if (freq, side) not in expected:
                expected[(freq, side)] = _expected_video(trainer, [str(p) for p in paths],
                                                         freq, side)
            want = expected[(freq, side)]
            lossless = res["codec"] == ["avi_raw"]     # XVID where cv2 imports
            for name in want:
                got = video_io.open_reader(logs / run / name)
                ok = got.frame_count == len(want[name]) and (not lossless or all(
                    np.array_equal(got.read(i), f) for i, f in enumerate(want[name])))
                if not ok:
                    raise AssertionError(f"{run}: {name} differs from the eval step's "
                                         "colormap")
            print(f"video {run} (cv2 {'hidden' if hide_cv2 else 'as installed'}: "
                  f"{installed_cv2 is not None}): {res['frames']} frames, codec {res['codec']}, readers "
                  f"{res['readers']}, {res['frames_per_sec']!r} frames/s, {wall!r} s "
                  f"wall in process; every output frame "
                  f"{'equal to' if lossless else 'counted against'} the eval step's "
                  f"colormap", flush=True)
            _expect_launches(launch_counts(), {}, f"video {run}")
            out["video"].append({"run": run, "frames_per_sec": res["frames_per_sec"],
                                 "codec": res["codec"]})

        lap("b")

        # (c) the serving export, served in a process without the port
        members = {"a_ocrnet_r50": {"model": "OCRNet", "backbone": "resnet50",
                                    "out_stride": 8, "ckpt": "published_t2"},
                   "b_upernet_r34": {"model": "EncDec", "encoder": {"model": "ResNet34"},
                                     "decoder": {"model": "UPerNet"}, "ckpt": "upn"}}
        upn = build_model({k: v for k, v in members["b_upernet_r34"].items() if k != "ckpt"},
                          2, device=dev, seed=1)
        save_checkpoint(logs / "upn" / "chkpts", "best", upn, 0, 0.0, 0.0)
        del upn
        ens = Trainer(dict(base, run_id="ens", graph={"model": "Ensemble",
                                                       "members": members}), device=dev)
        frames = np.stack([trainer.valid_set[i][0] for i in range(8)])
        dummy = np.zeros(frames.shape[:3], np.uint8)
        # the class and confidence of the Trainer's steps at batch 8 and at 1
        variants = (("ocrnet", trainer, False), ("ocrnet_tta", trainer, True),
                    ("ensemble", ens, False))
        refs = {}
        for name, tr, tta in variants:
            step = tr._make_tta_step() if tta else tr.eval_step
            refs[name] = {}
            for b in (8, 1):
                with torch.inference_mode():
                    out_step, _, _ = step(tr.model, frames[:b], dummy[:b])
                    out_step = out_step.float()
                    conf = (out_step.amax(1) if tta or tr.ensemble
                            else torch.softmax(out_step, 1).amax(1))
                refs[name][b] = (out_step.argmax(1).cpu().numpy(), conf.cpu().numpy())
        # the serving process starts now and loads each artifact once it is
        # marked ready, while the next one is exported; it serves them when
        # the exports are done
        np.save(tmp / "frames.npy", frames)
        artifacts = {name: tmp / f"{name}{export.SUFFIX}" for name, _, _ in variants}
        t_serve = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-c", _SERVE_ALONE, str(dev),
                                 str(tmp / "frames.npy")]
                                + [str(artifacts[k]) for k in artifacts],
                                cwd=tmp, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        try:
            export_s = {}
            for name, tr, tta in variants:
                t = time.perf_counter()
                if export.export_trainer(tr, tmp / name, tta=tta) != artifacts[name]:
                    raise AssertionError(f"export_trainer wrote elsewhere than "
                                         f"{artifacts[name]}")
                torch.cuda.synchronize()
                export_s[name] = time.perf_counter() - t
                pathlib.Path(str(artifacts[name]) + ".ready").touch()
            pathlib.Path(str(tmp / "frames.npy") + ".exports_done").touch()
            stdout, stderr = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        if proc.returncode != 0:
            raise AssertionError(f"serving without the port exited {proc.returncode}:\n"
                                 f"{stdout[-3000:]}\n{stderr[-3000:]}")
        served = json.loads(stdout.strip().splitlines()[-1])
        if served["port_modules"]:
            raise AssertionError(f"the serving process imported {served['port_modules']}")
        out["export"] = {}
        for name, path in artifacts.items():
            got = np.load(str(path) + ".served.npz")
            (pred, conf), (pred1, conf1) = refs[name][8], refs[name][1]
            share = float((got["pred8"] != pred).mean())
            conf_diff = float(np.abs(got["conf8"] - conf).max())
            b1_share = float((got["pred1"] != pred1).mean())
            b1_conf = float(np.abs(got["conf1"] - conf1).max())
            rec = dict(served["served"][str(path)], export_s=export_s[name],
                       pred_share=share, conf_diff=conf_diff, b1_share=b1_share,
                       b1_conf_diff=b1_conf, mb=path.stat().st_size / 1e6)
            print(f"export {name}: {json.dumps(rec)} (against the Trainer's step at the "
                  f"same precision; gates: pred share {EXPORT_PRED_SHARE}, confidence "
                  f"{EXPORT_CONF_TOL})", flush=True)
            if not (share <= EXPORT_PRED_SHARE and conf_diff <= EXPORT_CONF_TOL
                    and b1_share <= EXPORT_PRED_SHARE and b1_conf <= EXPORT_CONF_TOL):
                raise AssertionError(f"the served {name} disagrees with the Trainer")
            out["export"][name] = rec
        print(f"exports and the serving process beside them: "
              f"{time.perf_counter() - t_serve!r} s wall", flush=True)
        ens.close()
        trainer.close()
        del ens, trainer, model
        torch.cuda.empty_cache()

        lap("c")

        # (d) the semi recipe's pool from the training videos
        table_videos = video_files_from_split(list(POOL_TRAIN_VIDEOS))
        for rel, clip in zip(table_videos, clips):
            (data / rel).parent.mkdir(parents=True, exist_ok=True)
            _write_video(data / rel, clip)
        flagship = json.loads(pathlib.Path(CONFIG).read_text())
        cfg = dict(flagship, loss={"name": "SemiSupervisedLoss", "labeled": flagship["loss"],
                                   "pseudo_threshold": SEMI_THRESHOLD},
                   train=dict(flagship["train"], epochs=1), data_path=str(data),
                   log_path=str(logs), run_id="semi_videos", log_every_n_epochs=1)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        with _RunRecorder() as rec:
            semi = Trainer(cfg, device=dev)
            t = time.perf_counter()
            semi.train()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        launches = launch_counts()
        steps = len(rec.steps)
        excluded = excluded_frames_from_df(semi.train_df, list(POOL_TRAIN_VIDEOS))
        want_pool = sum(n - len([f for f in excluded.get(v, ()) if f < n])
                        for v, n in zip(POOL_TRAIN_VIDEOS, VIDEO_FRAMES))
        pool = semi.unlabeled_set
        n_valid_full = VALID_FRAMES // semi.valid_batch_size
        print(f"semi recipe, pool from {len(table_videos)} training videos in the port's "
              f"AVI ({[str(p) for p in table_videos]}): pool {len(pool)} frames (expected "
              f"{want_pool}; labelled frames left out {dict(excluded)}), {steps} steps, "
              f"{wall!r} s wall, peak {torch.cuda.max_memory_allocated()} bytes", flush=True)
        if not (isinstance(pool.base, VideoDataset) and len(pool) == want_pool > 0):
            raise AssertionError(f"the video pool holds {len(pool)} frames, not {want_pool}")
        _expect_launches(launches, {"bucket_hist": 2 * steps, "bucket_dlogits": 4 * steps,
                                    "fu_hist": n_valid_full}, "semi with the video pool")
        semi.close()
        out["pool"] = {"frames": len(pool), "steps": steps, "launches": launches}
        lap("d")
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 26: training and serving over several ranks
# ---------------------------------------------------------------------------

# the flagship's global batch at full width on two gloo ranks on one card
RANKS26, BATCH26 = 2, 8
# phase 8's float64 input, a global batch of 4 (2 a rank)
SMALL26 = dict(n=4, h=64, w=96, seed=1)
# the bf16 2-rank step against the one-process step on the same frames and
# draws: under global BatchNorm both compute the same function and differ
# only in the order of their sums (the BatchNorm statistics' over ranks,
# cuDNN's at batch 4 against batch 8), which bf16's 8-bit mantissa carries
# into the logits, and a random model's logits lie close, so argmaxes flip.
# An H100 read 0.0205 of the stride-8 matrix's pixels in another class and
# rank losses 2.9e-5 from their halves' (PERF.md §6); the gates sit about
# 3x and 17x above that, and below what BatchNorm over the local rows or
# draws not sliced move (PERF.md §6). The label counts (the matrix's
# columns) must be equal: they depend only on the rows and the draws
PAR_CM_SHARE = 0.06
PAR_LOSS_TOL = 5e-4


class RecordingLoss:
    """`loss_fn` that keeps its last call's total (a rank's own loss,
    before the step averages it over the ranks) and, with `keep`, its
    outputs, labels and keywords."""

    def __init__(self, loss_fn, keep: bool = False):
        self.loss_fn, self.keep = loss_fn, keep
        self.full_res = tuple(getattr(loss_fn, "full_res", ()))

    def __call__(self, outputs, labels, **kw):
        total, terms = self.loss_fn(outputs, labels, **kw)
        self.total = total.detach().clone()   # the step averages `total` in place
        if self.keep:
            self.outputs = {k: v.detach() for k, v in outputs.items()}
            self.labels, self.kw = labels, kw
        return total, terms


def flagship_step26(cfg, dev, group=None, keep: bool = False):
    """The flagship's seed-0 model, its train state and its train step
    (the config's recipe) on `dev` under `group`, with the loss recorded
    (`RecordingLoss`)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
        train_metrics_source)

    task = int(cfg["data"]["experiment"])
    model = build_model(cfg["graph"], task, device=dev, seed=0)
    state = create_train_state(model, cfg["train"], make_schedule(cfg["train"], 100))
    loss = RecordingLoss(build_loss(cfg["loss"], task, dev), keep)
    step = make_train_step(loss, device_spec(cfg["data"]["transforms"]), task, device=dev,
                           precision=cfg.get("precision", "bf16"),
                           train_metrics=train_metrics_source(cfg), group=group)
    return state, step, loss


def single26(cfg, dev, images, labels, ranks: int) -> dict:
    """Phase 26(b)'s reference: the flagship's first step in one process
    on the global batch (`flagship_step26`: the ranks' weights and draws),
    its confusion matrix, and the loss of each rank's rows of its outputs
    (the loss that rank computes of its own rows, `_sharded_loss`)."""
    state, step, loss = flagship_step26(cfg, dev, keep=True)
    m = step(state, images, labels, 0)
    n, k = len(images), len(images) // ranks
    halves = []
    with torch.no_grad():
        for r in range(ranks):
            rows = slice(r * k, (r + 1) * k)
            total, _ = loss.loss_fn({key: v[rows] if v.ndim and v.shape[0] == n else v
                                     for key, v in loss.outputs.items()},
                                    loss.labels[rows], **loss.kw)
            halves.append(float(total))
    return {"cm": m["confusion_matrix"].cpu(), "loss": float(m["loss"]), "halves": halves}


def held26(card, ref) -> dict:
    """The 2-rank bf16 step (`card`: each rank's record) against the
    one-process step (`single26`): whether the matrix's label counts are
    equal, the share of its pixels counted in another class, each rank's
    loss against its half's, and the reported loss against the ranks'
    mean."""
    cm, want = card[0]["cm"].long(), ref["cm"].long()
    local = [r["local_loss"] for r in card]
    # rows are the predicted class, columns the label (ops/metrics.py)
    return {"labels_equal": bool(torch.equal(cm.sum(0), want.sum(0))),
            "cm_share": float((cm - want).abs().sum()) / (2 * float(want.sum())),
            "rank_loss_diff": [abs(a - b) for a, b in zip(local, ref["halves"])],
            "mean_loss_diff": abs(card[0]["loss"] - float(np.mean(local))),
            "ranks_equal": all(torch.equal(r["cm"], cm) and r["loss"] == card[0]["loss"]
                               for r in card)}


class scalars_to_jsonl:
    """Tensorboard made absent for the block, so that a Trainer's TBLogger
    writes its scalars to scalars.jsonl, which the phase reads back."""

    def __enter__(self):
        self.saved = sys.modules.get("torch.utils.tensorboard")
        sys.modules["torch.utils.tensorboard"] = None

    def __exit__(self, *exc):
        if self.saved is None:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = self.saved


def run_process_group(cmd, timeout: float) -> subprocess.CompletedProcess:
    """`cmd` in a session of its own, killed whole (torchrun and its
    workers) if it outlasts `timeout`."""
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        raise AssertionError(f"{cmd} outlasted {timeout} s:\n{out[-3000:]}\n{err[-3000:]}")
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def rank26a(payload: str) -> int:
    """Phase 26(a)'s worker under torchrun (one rank, NCCL): the flagship
    through the port's CLI from the payload's config, the kernels' launches
    counted around it; then the world's backend and an NCCL all-reduce,
    and the flagship's train step timed in turns with no group and with the
    world's data group. Prints one line `RANK26A <json>`."""
    import torch.distributed as dist

    from miccai2021_cataract_semantic_segmentation_tpu_torch import main as port_main
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import (
        DataGroup, close, init_from_env)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
        train_metrics_source)

    p = json.loads(pathlib.Path(payload).read_text())
    reset_launches()
    with scalars_to_jsonl():
        port_main.main(["-c", p["config"], "-dp", p["data"]])
    launches = launch_counts()
    world = init_from_env("cuda")
    try:
        backend = dist.get_backend()
        t = torch.ones(3, device=world.device)
        dist.all_reduce(t)
        cfg = json.loads(pathlib.Path(p["config"]).read_text())
        task = int(cfg["data"]["experiment"])
        model = build_model(cfg["graph"], task, device=world.device, seed=0)
        state = create_train_state(model, cfg["train"], make_schedule(cfg["train"], 100))
        images, labels = synthetic_set(n=BATCH26)
        steps = {name: make_train_step(
            build_loss(cfg["loss"], task, world.device), device_spec(cfg["data"]["transforms"]),
            task, device=world.device, precision=cfg.get("precision", "bf16"),
            train_metrics=train_metrics_source(cfg), group=group)
            for name, group in (("plain", None), ("nccl", DataGroup.of(world, BATCH26)))}
        ms = {name: [] for name in steps}
        for name in ("plain", "nccl", "nccl", "plain"):
            ms[name].append(cuda_ms(lambda: steps[name](state, images, labels, 0),
                                    reps=3, warmup=1))
    finally:
        close(world)
    print("RANK26A " + json.dumps({
        "launches": launches, "backend": backend, "all_reduce": t.tolist(),
        "world": [world.rank, world.size, str(world.device)], "ms": ms}), flush=True)
    return 0


def rank26b(rank: int, world: int, payload: str) -> dict:
    """Phase 26(b)'s rank (parallel/launch.py: gloo, a FileStore), on the
    payload's device: on the card, gloo's all-reduces of CUDA tensors
    (the differentiable one with its gradient, and the in-place one) and the
    flagship's first train step at full width on this rank's half of a
    global batch of 8 in bf16 (`flagship_step26`), its launches counted,
    its summed matrix, reported loss and the rank's own loss, then the
    step's time; on both devices, the float64 step of phase 8's input over
    the two ranks (TF32 off, pad only)."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import (
        DataGroup, init_from_env)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step

    p = json.loads(pathlib.Path(payload).read_text())
    cfg = json.loads(pathlib.Path(CONFIG).read_text())
    task = int(cfg["data"]["experiment"])
    dev = torch.device(p["device"])
    w = init_from_env(dev)
    out = {}
    if dev.type == "cuda":
        group = DataGroup.of(w, BATCH26)
        x = torch.full((3,), float(rank + 1), device=dev, requires_grad=True)
        y = group.sum_(x * 2.0)
        y.sum().backward()
        t = torch.full((2,), rank + 1, device=dev, dtype=torch.int64)
        group.all_reduce_(t)
        out["gloo_cuda"] = {"sum": y.tolist(), "grad": x.grad.tolist(), "int64": t.tolist(),
                            "devices": [str(y.device), str(x.grad.device), str(t.device)]}
        images, labels = synthetic_set(n=BATCH26)
        rows = group.local_rows(BATCH26)
        state, step, loss = flagship_step26(cfg, dev, group)
        reset_launches()
        m = step(state, images[rows], labels[rows], 0)
        torch.cuda.synchronize()
        out["launches"] = launch_counts()
        out.update(loss=float(m["loss"]), local_loss=float(loss.total),
                   cm=m["confusion_matrix"].cpu())
        out["ms"] = cuda_ms(lambda: step(state, images[rows], labels[rows], 0),
                            reps=3, warmup=1)
        del state, step, loss
        torch.cuda.empty_cache()
        torch.backends.cudnn.allow_tf32 = False
    images, labels = synthetic_set(**SMALL26)
    group = DataGroup.of(w, SMALL26["n"])
    rows = group.local_rows(SMALL26["n"])
    model = build_model(cfg["graph"], task, device=dev, seed=0).to(torch.float64)
    state = create_train_state(model, cfg["train"], make_schedule(cfg["train"], 1))
    step = make_train_step(build_loss(cfg["loss"], task, dev), device_spec(["pad"]), task,
                           device=dev, precision="fp64", train_metrics="s8", group=group)
    m = step(state, images[rows], labels[rows], 0)
    out["f64"] = dict(loss=float(m["loss"]), norm=float(m["grad_norm"]),
                      cm=m["confusion_matrix"].cpu(), grads=flat_grads(model),
                      sd={k: v.cpu() for k, v in model.state_dict().items()})
    return out


def mesh_export26(dev, cfg) -> dict:
    """Phase 26(c): the flagship's serving program (seed-0 weights, bf16)
    exported over the mesh [cuda:0, cuda:0] at a pinned batch of 8 and
    served, against the one-device artifact (a symbolic batch) on each
    shard's 4 frames and on all 8; the export and serve times."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train import export
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import eval_spec

    task = int(cfg["data"]["experiment"])
    model = build_model(cfg["graph"], task, device=dev, seed=0).eval()
    serve = export.make_serving_fn(model, eval_spec(cfg["data"]["transforms"]),
                                   precision=cfg.get("precision", "bf16"))
    images, _ = synthetic_set(n=BATCH26)
    x = torch.from_numpy(images).to(dev)
    t = time.perf_counter()
    mesh = export.MeshServing(export.export_fn(serve, images.shape[1:3], batch=BATCH26,
                                               mesh=[dev, dev]), [dev, dev])
    t_mesh = time.perf_counter() - t
    t = time.perf_counter()
    one = export.export_fn(serve, images.shape[1:3]).module()
    t_one = time.perf_counter() - t
    with torch.no_grad():
        got = mesh(x)
        shards = [one(x[:4]), one(x[4:])]
        whole = one(x)
        ms = {"mesh": cuda_ms(lambda: mesh(x), reps=5, warmup=1),
              "one": cuda_ms(lambda: one(x), reps=5, warmup=1)}
    per_shard = {k: bool(torch.equal(got[k], torch.cat([s[k] for s in shards])))
                 for k in ("pred", "confidence")}
    return {"export_s": {"mesh": t_mesh, "one": t_one}, "serve_ms_b8": ms,
            "bit_equal_per_shard": per_shard,
            "pred_share_vs_batch8": float((got["pred"] != whole["pred"]).float().mean()),
            "conf_diff_vs_batch8": float((got["confidence"] - whole["confidence"]).abs().max())}


def phase26_parallel(dev, data) -> dict:
    """Training and serving over several ranks (see the module docstring);
    returns the 2-rank step's B1/B2 launches, summed over the ranks."""
    import tempfile

    from miccai2021_cataract_semantic_segmentation_tpu_torch import main as port_main
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.launch import Ranks
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.checkpoint import (
        read_checkpoint)

    smi = nvidia_smi()
    cfg = json.loads(pathlib.Path(CONFIG).read_text())
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_parallel_"))
    payloads = {}
    for kind in ("cuda:0", "cpu"):
        payloads[kind] = tmp / f"ranks_{kind.replace(':', '')}.json"
        payloads[kind].write_text(json.dumps({"device": kind}))
    # (b)'s replay on the CPU runs beside (a) and (c), which it leaves the
    # card to
    cpu_ranks = Ranks("chip_smoke:rank26b", RANKS26, payloads["cpu"], threads=2)
    try:

        # (a) one rank over NCCL through torchrun against the plain run
        logs = tmp / "logs"

        def write_config(run_id):
            c = json.loads(json.dumps(cfg))
            c["train"]["epochs"] = 1
            c.update(data_path=str(data), log_path=str(logs), run_id=run_id,
                     log_every_n_epochs=1, log_every_n_steps=1)
            path = tmp / f"{run_id}.json"
            path.write_text(json.dumps(c))
            return str(path)

        plain_cfg, nccl_cfg = write_config("plain"), write_config("nccl")
        reset_launches()
        t = time.perf_counter()
        with scalars_to_jsonl():
            port_main.main(["-c", plain_cfg, "-dp", str(data)])
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
        plain_launches = launch_counts()
        (tmp / "a.json").write_text(json.dumps({"config": nccl_cfg, "data": str(data)}))
        t = time.perf_counter()
        proc = run_process_group(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", os.path.join(ROOT, "chip_smoke.py"), "--rank26a",
             str(tmp / "a.json")], timeout=300)
        nccl_s = time.perf_counter() - t
        if proc.returncode != 0:
            raise AssertionError(f"the torchrun run exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        a = json.loads(next(ln for ln in proc.stdout.splitlines()
                            if ln.startswith("RANK26A "))[len("RANK26A "):])
        runs = {name: (read_checkpoint(logs / name / "chkpts" / "chkpt_last.pt"),
                       np.load(logs / name / "ind_dist.npz"),
                       [json.loads(ln)["value"] for ln in
                        (logs / name / "train" / "scalars.jsonl").read_text().splitlines()
                        if '"metrics/loss"' in ln],
                       json.loads((logs / name / "info.json").read_text())["metrics"])
                for name in ("plain", "nccl")}
        (ck_p, ind_p, loss_p, val_p), (ck_n, ind_n, loss_n, val_n) = runs["plain"], runs["nccl"]
        same_batches = sorted(ind_p.files) == sorted(ind_n.files) and all(
            np.array_equal(ind_p[k], ind_n[k]) for k in ind_p.files)
        weights_equal = all(torch.equal(v, ck_n["model_state_dict"][k])
                            for k, v in ck_p["model_state_dict"].items())
        n_steps = len(loss_p)
        print(f"26(a) one rank over torchrun ({a['backend']}, world {a['world']}, its "
              f"all-reduce of ones {a['all_reduce']}): {n_steps} steps, index batches "
              f"equal {same_batches}, step losses {loss_n} against the plain run's "
              f"{loss_p}, final weights bit-equal {weights_equal}, validation mIoU "
              f"{val_n['miou']!r} against {val_p['miou']!r}; launches {a['launches']} "
              f"against the plain run's {plain_launches}; wall {nccl_s!r} s (a process "
              f"of its own) against {plain_s!r} s in process", flush=True)
        print(f"26(d) the flagship train step (544x960, batch 8, bf16), CUDA events, "
              f"medians of 3 in turns plain/NCCL/NCCL/plain: plain {a['ms']['plain']} ms, "
              f"one NCCL rank {a['ms']['nccl']} ms; card {smi}", flush=True)
        bad = []
        if a["backend"] != "nccl" or a["all_reduce"] != [1.0, 1.0, 1.0] or \
                a["world"] != [0, 1, "cuda:0"]:
            bad.append(f"(a) the world: {a['backend']}, {a['world']}, {a['all_reduce']}")
        if not (same_batches and weights_equal and loss_n == loss_p and val_n == val_p
                and a["launches"] == plain_launches and n_steps > 0
                and plain_launches["fu_grad"] == n_steps):
            bad.append("(a) the one-rank NCCL run differs from the plain run")

        # (c) the export over a mesh of [cuda:0, cuda:0]
        c = mesh_export26(dev, cfg)
        print(f"26(c) the flagship's serving export over [cuda:0, cuda:0] at batch 8: "
              f"{json.dumps(c)}; card {smi}", flush=True)
        if not all(c["bit_equal_per_shard"].values()):
            bad.append(f"(c) the mesh artifact differs from the one-device one: {c}")

        # (b) two gloo ranks on cuda:0, and their float64 step replayed on the CPU
        torch.cuda.empty_cache()
        t = time.perf_counter()
        card = Ranks("chip_smoke:rank26b", RANKS26, payloads["cuda:0"]).results(timeout=300)
        card_s = time.perf_counter() - t
        cpu = cpu_ranks.results(timeout=300)
        g = [r["gloo_cuda"] for r in card]
        print(f"26(b) gloo with CUDA tensors: {g}", flush=True)
        if any(r["sum"] != [6.0] * 3 or r["grad"] != [4.0] * 3 or r["int64"] != [3, 3]
               or any(not d.startswith("cuda") for d in r["devices"]) for r in g):
            bad.append(f"(b) gloo's all-reduce of CUDA tensors: {g}")
        launches = [r["launches"] for r in card]
        print(f"26(b) two ranks on cuda:0 (gloo), the flagship's first step at 544x960, "
              f"global batch 8 (4 a rank), bf16: reported losses "
              f"{[r['loss'] for r in card]}, the ranks' own {[r['local_loss'] for r in card]}, "
              f"matrix counts {[int(r['cm'].sum()) for r in card]}, launches a rank in "
              f"the step {launches}; then the step {[r['ms'] for r in card]} ms a rank "
              f"(CUDA events, median of 3, both ranks sharing the card); the ranks' wall "
              f"{card_s!r} s (two processes of their own); card {smi}", flush=True)
        want = dict(dict.fromkeys(KERNELS, 0), fu_hist=1, fu_grad=1)
        if any(n != want for n in launches) or \
                not np.isfinite([r["local_loss"] for r in card]).all():
            bad.append(f"(b) launches {launches} (want {want}) or losses "
                       f"{[r['local_loss'] for r in card]}")
        images, labels = synthetic_set(n=BATCH26)
        ref = single26(cfg, dev, images, labels, RANKS26)
        held = held26(card, ref)
        print(f"26(b) the same step in one process on the same 8 frames and draws: loss "
              f"{ref['loss']!r}, the loss of each rank's half of its outputs "
              f"{ref['halves']}; the 2-rank step against it: {json.dumps(held)} (gates: "
              f"label counts equal, matrix share {PAR_CM_SHARE}, a rank's loss "
              f"{PAR_LOSS_TOL}, the reported loss the ranks' mean within 1e-6)", flush=True)
        if not (held["labels_equal"] and held["ranks_equal"]
                and held["cm_share"] <= PAR_CM_SHARE
                and max(held["rank_loss_diff"]) <= PAR_LOSS_TOL
                and held["mean_loss_diff"] <= 1e-6):
            bad.append(f"(b) the 2-rank bf16 step against one process: {held}")
        lr = float(cfg["train"]["learning_rate"])
        g64, h64 = card[0]["f64"], cpu[0]["f64"]
        stats = [k for k in h64["sd"] if k.endswith(("running_mean", "running_var"))]
        params = [k for k in h64["sd"] if k not in stats
                  and not k.endswith("num_batches_tracked")]
        got = dict(loss=abs(g64["loss"] - h64["loss"]),
                   grads=rel_l2(g64["grads"], h64["grads"]),
                   grad_norm=abs(g64["norm"] / h64["norm"] - 1),
                   stats=max(rel_l2(g64["sd"][k], h64["sd"][k]) for k in stats),
                   params=max(float((g64["sd"][k] - h64["sd"][k]).abs().max())
                              for k in params) / lr,
                   cm_l1=int((g64["cm"] - h64["cm"]).abs().sum()))
        ranks_agree = all(torch.equal(card[0]["f64"]["sd"][k], card[1]["f64"]["sd"][k])
                          for k in g64["sd"])
        print(f"26(b) the 2-rank float64 step (2x64x96 a rank, TF32 off, pad only) on "
              f"the card against the same 2-rank step on the CPU: {json.dumps(got)} "
              f"(gates {json.dumps(F64_TOL)}, matrix equal); the card's ranks hold "
              f"equal weights {ranks_agree}", flush=True)
        if any(v > F64_TOL[k] for k, v in got.items() if k != "cm_l1") or got["cm_l1"] \
                or not ranks_agree:
            bad.append(f"(b) the 2-rank float64 step, card against CPU: {got}")
        if bad:
            raise AssertionError("phase 26: " + "; ".join(bad))
        return {k: sum(n[k] for n in launches) for k in ("fu_hist", "fu_grad")}
    finally:
        cpu_ranks.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 27: the offline tools, the reproduction harness and the twins
# ---------------------------------------------------------------------------

TWIN27 = dict(backbone="resnet50", h=540, w=960, bs=8, n_pool=32, n_steps=20,
              n_buckets=1024, lr=1e-4, data_seed=0)
TWIN27_FIRST_GAP = 1e-3     # tests/test_trajectory_twins.py's envelope


def twins27(dev) -> dict:
    """(a) The sort and bucket twins at full width through the port's
    tools/trajectory_twins.py, the launches of each step read around it."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.trajectory_twins import (
        compare_twins)

    steps = {"sort": [], "bucket": []}
    last = {}

    def on_step(impl, i, metrics):
        now = launch_counts()
        steps[impl].append({k: now[k] - last.get(k, 0) for k in now})
        last.update(now)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    r = compare_twins(**TWIN27, device=dev, on_step=on_step)
    peak = torch.cuda.max_memory_allocated()
    none = dict.fromkeys(KERNELS, 0)
    one = dict(none, fu_hist=1, fu_grad=1)
    print("phase 27 twins (OCRNet-R50 os8, 540x960 padded to 544x960, batch 8, bf16, "
          f"B 1024, {TWIN27['n_steps']} steps a twin): sort losses {r['losses_sort']}, "
          f"bucket losses {r['losses_bucket']}; first-step gap "
          f"{abs(r['losses_sort'][0] - r['losses_bucket'][0])!r}, tail gap "
          f"{r['final_tail_divergence']!r}, largest gap {r['max_abs_loss_divergence']!r}, "
          f"rel_param_distance {r['rel_param_distance']!r}; ms/step (host clock, "
          f"model build included) sort {r['ms_per_step_sort']!r}, bucket "
          f"{r['ms_per_step_bucket']!r}; peak memory {peak} bytes", flush=True)
    if any(s != none for s in steps["sort"]) or any(s != one for s in steps["bucket"]):
        raise AssertionError(f"twin launches a step: sort {steps['sort']}, "
                             f"bucket {steps['bucket']}")
    if len(steps["bucket"]) != TWIN27["n_steps"] or not all(
            np.isfinite(r["losses_sort"] + r["losses_bucket"])):
        raise AssertionError("a twin's loss is not finite, or a step is missing")
    if abs(r["losses_sort"][0] - r["losses_bucket"][0]) > TWIN27_FIRST_GAP:
        raise AssertionError(f"first-step losses {r['losses_sort'][0]} and "
                             f"{r['losses_bucket'][0]} differ by more than "
                             f"{TWIN27_FIRST_GAP}")
    return {"fu_hist": sum(s["fu_hist"] for s in steps["bucket"]),
            "fu_grad": sum(s["fu_grad"] for s in steps["bucket"])}


def reproduce27(dev, data, tmp) -> None:
    """(b) The port's tools/reproduce_paper.py on phase 20's tree from seed-0
    OCRNet-R50 .pt files for t1-t3: exit 1, each task's mIoU that of
    `Trainer.infer` on the same config and frames, no kernel launched."""
    import contextlib
    import io

    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import reproduce_paper
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.checkpoint import (
        save_checkpoint)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer

    ckpts = {}
    for task in (1, 2, 3):
        cfg = json.loads((pathlib.Path(ROOT) / "configs" / PRETRAINED[task - 1]).read_text())
        model = build_model(cfg["graph"], task, device=dev, seed=0)
        ckpts[task] = save_checkpoint(tmp / f"published_t{task}" / "chkpts", "best",
                                      model, 0, 0.0, 0.0)
        del model
    argv = ["--data-root", str(data), "--log-path", str(tmp / "logs"), "--device", str(dev)]
    argv += [a for task, path in ckpts.items() for a in ("--ckpt", f"{task}={path}")]
    reset_launches()
    printed = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        try:
            reproduce_paper.main(argv)
            code = 0
        except SystemExit as exc:
            code = exc.code
    seconds = time.perf_counter() - t
    launches = launch_counts()
    out = printed.getvalue().strip().splitlines()
    print("\n".join(line for line in out if not line.startswith("[")), flush=True)
    rows = {r["task"]: r for r in json.loads(out[-1])["results"]}
    args = reproduce_paper.build_argparser().parse_args(argv)
    for task, path in ckpts.items():
        trainer = Trainer(reproduce_paper.task_config(task, path, args), device=dev)
        with contextlib.redirect_stdout(io.StringIO()):
            want = 100.0 * trainer.infer()["miou"]
        trainer.close()
        if rows[task]["miou"] != want:
            raise AssertionError(f"t{task}: the harness's mIoU {rows[task]['miou']} is "
                                 f"not Trainer.infer's {want}")
    print(f"phase 27 reproduce_paper: exit {code} in {seconds!r} s wall (three tasks); "
          "each task's mIoU equals Trainer.infer's on its config and frames; launches "
          f"{launches}", flush=True)
    if code != 1 or launches != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"reproduce_paper exited {code} (expected 1: random weights) "
                             f"with launches {launches}")


def data_tools27(data, tmp) -> None:
    """(c) build_frame_table, class_analysis and add_blacklist over the
    tree: the frame table's paths and counts those of the tree's data.csv."""
    import contextlib
    import io

    from miccai2021_cataract_semantic_segmentation_tpu_torch import taxonomy
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import FrameTable
    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools import (
        add_blacklist, build_frame_table, class_analysis)

    t = time.perf_counter()
    built = build_frame_table.build_frame_table(data)
    seconds = time.perf_counter() - t
    tree = FrameTable.read_csv(data / "data.csv")
    order = np.argsort(tree["img_path"].astype(str), kind="stable")
    by_path = tree.take(order)
    if not np.array_equal(built["img_path"].astype(str), by_path["img_path"].astype(str)) \
            or not np.array_equal(built["lbl_path"].astype(str),
                                  by_path["lbl_path"].astype(str)):
        raise AssertionError("build_frame_table's paths are not the tree's")
    for name in taxonomy.CANONICAL_NAMES:
        if not np.array_equal(built[name], by_path[name]):
            raise AssertionError(f"build_frame_table's {name} counts are not the tree's")
    shares = {task: class_analysis.class_distribution(built, task) for task in (1, 2, 3)}
    quality = class_analysis.split_quality(built, 2)
    built.to_csv(tmp / "table.csv")
    with contextlib.redirect_stdout(io.StringIO()):
        add_blacklist.main(["--label-table", str(tmp / "table.csv"),
                            "--csv", str(tmp / "table.csv"), "-o", str(tmp / "joined.csv")])
    if (tmp / "joined.csv").read_bytes() != (tmp / "table.csv").read_bytes():
        raise AssertionError("add_blacklist did not round-trip the table")
    if any(abs(float(np.nansum(shares[t]["pixel_share"])) - 1) > 1e-12 for t in shares) \
            or quality["test_frames"] != int(np.isin(built["vid_num"], TEST_VIDEOS).sum()):
        raise AssertionError("class_distribution or split_quality is off")
    print(f"phase 27 data tools: build_frame_table {len(built)} frames in {seconds!r} s, "
          "paths and 36 class counts equal to the tree's data.csv; class_distribution "
          f"t1-t3 and split_quality (test frames {quality['test_frames']}, t2 classes "
          f"missing from test {len(quality['test_t2_missing'])}); add_blacklist round-trips",
          flush=True)


def phase27_tools(dev) -> dict:
    """The offline tools, the reproduction harness and the twins (see the
    module docstring); returns the bucket twin's B1/B2 launches."""
    import shutil
    import tempfile

    from miccai2021_cataract_semantic_segmentation_tpu_torch.tools.synthetic_tree import (
        canonical_from_network)

    launches = twins27(dev)
    images, labels = synthetic_set()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_tools_"))
    try:
        write_served_tree(tmp / "data", images, canonical_from_network(labels, 2))
        reproduce27(dev, tmp / "data", tmp)
        data_tools27(tmp / "data", tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# phase 28: the spatial grid, activation rows split over ranks
# ---------------------------------------------------------------------------

# the JAX dry run's 2-D mesh on one card: one data rank, two model ranks,
# each holding 272 of the 544 padded rows of every activation
GRID28, BATCH28 = (1, 2), 8
# (a) the grid's float32 step (TF32 off) against one process's on the same
# frames, weights and draws: both compute one function and differ in the
# order of their sums (cuDNN's algorithms at 272 against 544 rows, the
# BatchNorm and OCR-context sums split over two ranks), float32 rounding.
# A pair on a bucket's edge may then change bucket, which moves the
# Lovász gradient by a step of its own, and Adam's first update,
# lr * g / (|g| + eps), changes sign where g lies within rounding of 0.
# How far rounding moves this step is measured in the same run: the
# one-process step from the same weights scaled by 1 + GRID28_NOISE * a
# normal draw (one or two float32 ulps a weight). The grid is held to
# GRID28_RATIO times that distance (or to the floor, where the noise moved
# less) in grad_norm (relative), the BatchNorm statistics (largest
# relative L2 over the buffers) and the share of parameters whose update
# differs by more than lr / 2; its loss and terms within 1e-5 of one
# process's (a loss of about 1.3); no parameter further than 2 lr. An
# H100 read the grid 2.0e-3, 8.6e-6 and 1.9e-3 away, the noise 2.7e-3,
# 8.2e-6 and 3.7e-3 (PERF.md §6)
GRID28_NOISE = 1e-7
GRID28_RATIO = 3.0
GRID28_FLOOR = {"grad_norm": 1e-4, "stats": 1e-5, "flip_share": 1e-4}
GRID28_LOSS_TOL = 1e-5
# (c) the eval step (float32, TF32 off) of the same weights, the
# one-process step's: the share of the 8 x 544 x 960 pixels whose class
# differs from one process's, held to GRID28_RATIO times the share that
# GRID28_NOISE on those weights moves (floor 1e-4): after one step the
# eval-mode BatchNorms hold their initial statistics and many pixels'
# top two logits lie within rounding of each other
GRID28_PIXEL_FLOOR = 1e-4
# (f) a rank's peak memory in the step over the one-process step's: the
# trunk's activations, most of the step's memory at output stride 8, are
# split in two; the weights, Adam's moments, the frames and the gathered
# logits are not. Each peak leaves out what the process held before the
# step's model was built (`live_bytes`: earlier phases' leftovers)
GRID28_MEMORY_SHARE = 0.8
# (g) the other graphs the grid splits, each float32 (TF32 off) against
# one process at GRID28_GRAPH_BATCH frames of 544 padded rows: train steps
# of HRNetv2-W32 (its full-resolution bucket Lovász: B3, B4f) and
# DeepLabv3-R50 os8 (the single-scale fused route: B1, B2; 34 rows a rank
# at stride 8 under the ASPP's 36-row halo), held as (a) and to
# GRID28_MEMORY_SHARE; eval-loss steps of OCRNet on HRNet-W18 (the
# flagship's loss from stride 4: B1) and DeepLabv3+-R50 (B1), their loss
# within GRID28_RATIO times what GRID28_NOISE moves it (floor
# GRID28_LOSS_TOL) and their classes as (c)
GRID28_GRAPH_BATCH = 2


def grid28_graphs() -> dict:
    """name -> (config, "train" or "eval_loss", the launches of a rank's
    step) of phase 28(g)."""
    with open(CONFIG) as f:
        flagship = json.load(f)
    return {
        "HRNetv2-W32": (hrnet_config(), "train", {"bucket_hist": 1, "bucket_dlogits": 1}),
        "DeepLabv3-R50": (deeplab_config(), "train", {"fu_hist": 1, "fu_grad": 1}),
        "OCRNet-HRNet-W18": (dict(flagship, graph={"model": "OCRNet",
                                                   "backbone": "hrnetv2_w18"}),
                             "eval_loss", {"fu_hist": 1}),
        "DeepLabv3+-R50": (deeplab_config({"model": "DeepLabv3Plus", "backbone": "resnet50",
                                           "out_stride": 8}), "eval_loss", {"fu_hist": 1}),
    }


def grid28_decoders() -> dict:
    """name -> (config, "train" or "eval_loss", the launches of a rank's
    step) of phase 28(h): configs/UPN_rf_lvsz.json (its LossWrapper sent
    to the bucket route) with UPerNet-R34 as shipped, FCN at width 1.0,
    UNet, and UPerNet on ResNeXt-50."""
    upn = upernet_config()
    generic = {"bucket_hist": 1, "bucket_dlogits": 1}
    return {
        "UPerNet-R34": (upn, "train", {"fu_hist": 1, "fu_grad": 1}),
        "FCN": (dict(upn, graph={"model": "FCN", "width": 1.0}), "train", generic),
        "UNet": (dict(upn, graph={"model": "UNet"}), "train", generic),
        "UPerNet-ResNeXt50": (dict(upn, graph={"model": "UPerNet",
                                               "encoder": {"model": "ResNeXt50"}}),
                              "eval_loss", {"fu_hist": 1}),
    }


def live_bytes(dev) -> int:
    """The bytes allocated on the card before a step's model is built
    (what earlier work left in the process), which its peak leaves out."""
    return torch.cuda.memory_allocated() if torch.device(dev).type == "cuda" else 0


def noisy_(model, seed: int = 28) -> None:
    """Scale every parameter by 1 + GRID28_NOISE * a seeded normal draw."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(1 + GRID28_NOISE * torch.randn(p.shape, generator=gen,
                                                  dtype=p.dtype).to(p.device))


def step_distance(a: dict, b: dict, lr: float) -> dict:
    """How far step record `a` lies from `b` (`grid28_record`)."""
    stats = [k for k in b["sd"] if k.endswith(("running_mean", "running_var"))]
    params = [k for k in b["sd"] if k not in stats and not k.endswith("num_batches_tracked")]
    dp = torch.cat([(a["sd"][k] - b["sd"][k]).double().reshape(-1) for k in params])
    return {"loss": max(abs(a["scalars"][k] - b["scalars"][k])
                        for k in b["scalars"] if k != "grad_norm"),
            "grad_norm": abs(a["scalars"]["grad_norm"] / b["scalars"]["grad_norm"] - 1),
            "stats": max((rel_l2(a["sd"][k], b["sd"][k]) for k in stats), default=0.0),
            "flip_share": float((dp.abs() > lr / 2).double().mean()),
            "params_max_over_lr": float(dp.abs().max()) / lr,
            "cm_share": float((a["cm"] - b["cm"]).abs().sum()) / (2 * float(b["cm"].sum()))}


def grid28_step(cfg, dev, precision: str, group=None):
    """The flagship's seed-0 model, train state and train step (the
    config's loss and augmentation) on `dev` at `precision` over `group`."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import device_spec
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import make_train_step

    task = int(cfg["data"]["experiment"])
    model = build_model(cfg["graph"], task, device=dev, seed=0)
    state = create_train_state(model, cfg["train"], make_schedule(cfg["train"], 100))
    step = make_train_step(build_loss(cfg["loss"], task, dev),
                           device_spec(cfg["data"]["transforms"]), task, device=dev,
                           precision=precision, train_metrics="s8", group=group)
    return model, state, step


def forward_end_bytes(model) -> dict:
    """The memory allocated on the card when the model's first forward
    reaches its last convolution (`conv_out`), recorded under "bytes"."""
    seen = {}

    def record(module, inputs, output):
        if "bytes" not in seen and output.is_cuda:
            seen["bytes"] = torch.cuda.memory_allocated()

    model.conv_out.register_forward_hook(record)
    return seen


def grid28_record(model, m) -> dict:
    """A step's numbers on the CPU: its scalars, matrix and state dict."""
    return {"scalars": {k: float(v) for k, v in m.items() if v.ndim == 0},
            "cm": m["confusion_matrix"].cpu(),
            "sd": {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}}


def grid28_eval(cfg, dev, model, images, labels, group=None):
    """The eval step (float32) of `model` over `group`: its predicted
    classes (this rank's rows) and its matrix."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_spec, make_eval_step)
    step = make_eval_step(eval_spec(cfg["data"]["transforms"]), 17, device=dev,
                          precision="fp32", group=group)
    logits, _, cm = step(model, images, labels)
    return logits.argmax(1).to(torch.uint8).cpu(), cm.cpu()


def grid28_graph(cfg, kind: str, dev, images, labels, group=None, noise: bool = False,
                 timed: bool = False) -> dict:
    """One phase-28(g) run of `cfg`'s graph, float32, over `group` (None:
    one process): a train step from the seed-0 weights (moved by
    GRID28_NOISE with `noise`) and its record, or an eval-loss step of
    them and its loss, matrix and classes (this rank's rows); the step's
    launches and peak memory; with `timed` its ms (CUDA events, median of
    2) and, over a group, a step's seconds inside gloo's all-reduces."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
        eval_spec, make_eval_loss_step)

    task = int(cfg["data"]["experiment"])
    base = live_bytes(dev)
    if kind == "train":
        model, state, step = grid28_step(cfg, dev, "fp32", group)
        args = (state, images, labels, 0)
    else:
        model = build_model(cfg["graph"], task, device=dev, seed=0)
        step = make_eval_loss_step(build_loss(cfg["loss"], task, dev),
                                   eval_spec(cfg["data"]["transforms"]), device=dev,
                                   precision="fp32", num_classes=17, group=group)
        args = (model, images, labels, 0)
    if noise:
        noisy_(model)
    cuda = torch.device(dev).type == "cuda"     # a CPU rehearsal measures nothing
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = step(*args)
    if kind == "train":
        rec = grid28_record(model, out)
    else:
        logits, _, cm, loss = out
        rec = {"loss": float(loss), "cm": cm.cpu(),
               "pred": logits.argmax(1).to(torch.uint8).cpu()}
    rec["launches"] = launch_counts()
    if cuda:
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    if timed and cuda:
        rec["ms"] = cuda_ms(lambda: step(*args), reps=2, warmup=1)
        if group is not None:
            with gloo_timer() as gt:
                t = time.perf_counter()
                step(*args)
                torch.cuda.synchronize()
                rec["timed_step_s"] = time.perf_counter() - t
            rec["gloo_s"], rec["gloo_calls"] = gt.seconds, gt.calls
    del model, step, args, out
    if cuda:
        torch.cuda.empty_cache()
    return rec


class gloo_timer:
    """Wall seconds inside `dist.all_reduce` for the block, the card
    synchronised before each call starts the clock and after it ends."""

    def __enter__(self):
        import torch.distributed as dist
        self.dist, self.orig, self.seconds, self.calls = dist, dist.all_reduce, 0.0, 0

        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.orig(*a, **k)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t
            self.calls += 1
            return out

        dist.all_reduce = timed
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig


def rank28(rank: int, world: int, payload: str) -> dict:
    """Phase 28's rank (parallel/launch.py: gloo, a FileStore) on cuda:0,
    one of the (1, 2) grid's model ranks: (a) the flagship's float32 step
    (TF32 off) on the global batch's frames, its launches and its peak
    memory counted, then its time, and a step with gloo's all-reduces
    timed; (b) a bf16 step from the same weights; (c) the eval step of (a)'s
    weights; (d) rank 0 saves (a)'s model and train state, both ranks
    restore them into a fresh model and state; (g) the other graphs' and
    (h) the decoders' float32 steps (`grid28_graph`), each timed."""
    import torch.distributed as dist

    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
    from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel import Grid, init_from_env
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
    from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state

    p = json.loads(pathlib.Path(payload).read_text())
    cfg = json.loads(pathlib.Path(CONFIG).read_text())
    dev = torch.device(p["device"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    grid = Grid.of(init_from_env(dev), GRID28)
    images, labels = synthetic_set(n=BATCH28, h=p["h"], w=p["w"])
    rows = grid.local_rows(BATCH28)
    images, labels = images[rows], labels[rows]
    out = {"grid": [grid.rank, list(grid.shape), grid.m]}

    base = live_bytes(dev)
    model, state, step = grid28_step(cfg, dev, "fp32", grid)
    forward_end = forward_end_bytes(model)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    m = step(state, images, labels, 0)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        out["forward_end_bytes"] = forward_end["bytes"] - base
    out["launches"] = launch_counts()
    out["f32"] = grid28_record(model, m)
    one = build_model(cfg["graph"], int(cfg["data"]["experiment"]), device=dev, seed=1)
    one.load_state_dict(torch.load(p["one"], map_location=dev, weights_only=True))
    out["pred"], out["eval_cm"] = grid28_eval(cfg, dev, one, images, labels, grid)
    del one
    directory = pathlib.Path(p["dir"])
    if grid.chief:
        ckpt.save_checkpoint(directory, "last", model, 1, 0.0, 0.0, state)
    dist.barrier()
    fresh = build_model(cfg["graph"], int(cfg["data"]["experiment"]), device=dev, seed=1)
    fresh_state = create_train_state(fresh, cfg["train"], make_schedule(cfg["train"], 100))
    ckpt.restore_checkpoint(directory, "last", fresh, fresh_state)
    a, b = state.optimizer.state_dict(), fresh_state.optimizer.state_dict()
    out["restore_equal"] = all(torch.equal(v, fresh.state_dict()[k])
                               for k, v in model.state_dict().items()) and all(
        torch.equal(a["state"][i][k], b["state"][i][k])
        for i in a["state"] for k in a["state"][i]) and fresh_state.step == state.step
    out["wrote"] = grid.chief
    dist.barrier()
    del fresh, fresh_state, a, b
    if dev.type == "cuda":
        out["ms"] = cuda_ms(lambda: step(state, images, labels, 0), reps=3, warmup=1)
        with gloo_timer() as gt:
            t = time.perf_counter()
            step(state, images, labels, 0)
            torch.cuda.synchronize()
            out["timed_step_s"] = time.perf_counter() - t
        out["gloo_s"], out["gloo_calls"] = gt.seconds, gt.calls
    del model, state, step
    model, state, step = grid28_step(cfg, dev, "bf16", grid)
    m = step(state, images, labels, 0)
    out["bf16"] = {"loss": float(m["loss"]), "cm": m["confusion_matrix"].cpu()}
    del model, state, step, m
    torch.cuda.empty_cache()
    # (g) the other graphs, float32, TF32 off
    images, labels = synthetic_set(n=GRID28_GRAPH_BATCH, h=p["h"], w=p["w"])
    rows = grid.local_rows(GRID28_GRAPH_BATCH)
    for part, graphs in (("graphs", grid28_graphs()), ("decoders", grid28_decoders())):
        out[part] = {name: grid28_graph(gcfg, kind, dev, images[rows], labels[rows], grid,
                                        timed=True)
                     for name, (gcfg, kind, _) in graphs.items()}
    return out


def phase28_spatial(dev, h: int = 540, w: int = 960) -> dict:
    """The spatial grid on the card (see the module docstring); returns
    B1/B2's launches over the grid's float32 step, summed over the ranks."""
    import tempfile

    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import (
        KERNELS, launch_counts, reset_launches)
    from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.launch import Ranks

    smi = nvidia_smi()
    cfg = json.loads(pathlib.Path(CONFIG).read_text())
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="cadis_grid_"))
    try:
        payload = tmp / "grid.json"
        payload.write_text(json.dumps({"device": str(dev), "h": h, "w": w,
                                       "dir": str(tmp / "chkpts"),
                                       "one": str(tmp / "one.pt")}))
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        images, labels = synthetic_set(n=BATCH28, h=h, w=w)
        try:
            # one process: the float32 step, its peak memory and time; the eval
            base = live_bytes(dev)
            model, state, step = grid28_step(cfg, dev, "fp32")
            forward_end = forward_end_bytes(model)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            m = step(state, images, labels, 0)
            torch.cuda.synchronize()
            one_peak = torch.cuda.max_memory_allocated() - base
            one_forward_end = forward_end.get("bytes", base) - base
            one_launches = launch_counts()
            one = grid28_record(model, m)
            torch.save(model.state_dict(), tmp / "one.pt")
            one_pred, one_cm = grid28_eval(cfg, dev, model, images, labels)
            noisy_(model)
            noise_pred, _ = grid28_eval(cfg, dev, model, images, labels)
            one_ms = cuda_ms(lambda: step(state, images, labels, 0), reps=3, warmup=1)
            del model, state, step, m
            # the rounding reference: the same step from weights moved by noise
            model, state, step = grid28_step(cfg, dev, "fp32")
            noisy_(model)
            noise = grid28_record(model, step(state, images, labels, 0))
            del model, state, step
            model, state, step = grid28_step(cfg, dev, "bf16")
            m = step(state, images, labels, 0)
            one_bf16 = {"loss": float(m["loss"]), "cm": m["confusion_matrix"].cpu()}
            del model, state, step, m
            torch.cuda.empty_cache()
            # (g) and (h): each graph in one process, and from weights moved
            # by noise
            g_images, g_labels = synthetic_set(n=GRID28_GRAPH_BATCH, h=h, w=w)
            parts = {"graphs": grid28_graphs(), "decoders": grid28_decoders()}
            g_one, g_noise = {}, {}
            for part, graphs in parts.items():
                g_one[part] = {name: grid28_graph(gcfg, kind, dev, g_images, g_labels,
                                                  timed=True)
                               for name, (gcfg, kind, _) in graphs.items()}
                g_noise[part] = {name: grid28_graph(gcfg, kind, dev, g_images, g_labels,
                                                    noise=True)
                                 for name, (gcfg, kind, _) in graphs.items()}
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        t = time.perf_counter()
        ranks = Ranks("chip_smoke:rank28", GRID28[0] * GRID28[1], payload).results(
            timeout=300)
        ranks_s = time.perf_counter() - t
        bad = []
        want = dict(dict.fromkeys(KERNELS, 0), fu_hist=1, fu_grad=1)
        launches = [r["launches"] for r in ranks]
        if any(n != want for n in launches) or one_launches != want:
            bad.append(f"(e) launches {launches}, one process {one_launches} (want {want})")
        # (a) the float32 step against one process
        f32 = ranks[0]["f32"]
        lr = float(cfg["train"]["learning_rate"])
        got = step_distance(f32, one, lr)
        ref = step_distance(noise, one, lr)
        gates = {k: max(GRID28_RATIO * ref[k], floor) for k, floor in GRID28_FLOOR.items()}
        ranks_equal = all(torch.equal(r["f32"]["sd"][k], f32["sd"][k])
                          for r in ranks[1:] for k in f32["sd"]) and all(
            r["f32"]["scalars"] == f32["scalars"] for r in ranks)
        print(f"28(a) the (1, 2) grid of two gloo ranks on cuda:0 ({h + 4} padded rows, "
              f"half a rank), the flagship's float32 step (TF32 off) at {h}x{w}, batch "
              f"{BATCH28}, against one process: {json.dumps(got)}; the one-process step "
              f"from weights moved by {GRID28_NOISE} (relative) against it: "
              f"{json.dumps(ref)}; gates {json.dumps(gates)}, loss {GRID28_LOSS_TOL}, "
              f"params within 2 lr; ranks equal {ranks_equal}; scalars {f32['scalars']} "
              f"against {one['scalars']}; card {smi}", flush=True)
        if any(got[k] > g for k, g in gates.items()) or got["loss"] > GRID28_LOSS_TOL or \
                got["params_max_over_lr"] > 2.0 + 1e-3 or not ranks_equal:
            bad.append(f"(a) the grid's float32 step against one process: {got}")
        print(f"28(a) step times (CUDA events, median of 3, TF32 off): one process "
              f"{one_ms!r} ms; grid ranks {[r.get('ms') for r in ranks]} ms (both on one "
              f"card); a step with the all-reduces timed: "
              f"{[r.get('timed_step_s') for r in ranks]} s, of it inside gloo's all-reduces "
              f"{[r.get('gloo_s') for r in ranks]} s over "
              f"{[r.get('gloo_calls') for r in ranks]} calls; the ranks' wall {ranks_s!r} s; "
              f"card {smi}", flush=True)
        # (b) bf16
        b16 = ranks[0]["bf16"]
        b16_share = float((b16["cm"] - one_bf16["cm"]).abs().sum()) / (
            2 * float(one_bf16["cm"].sum()))
        print(f"28(b) one bf16 step on the grid against one process: loss "
              f"{b16['loss']!r} against {one_bf16['loss']!r} (difference "
              f"{abs(b16['loss'] - one_bf16['loss'])!r}), the stride-8 matrix's share of "
              f"pixels in another class {b16_share!r}; card {smi}", flush=True)
        if not np.isfinite(b16["loss"]) or not torch.equal(b16["cm"].sum(0),
                                                           one_bf16["cm"].sum(0)):
            bad.append("(b) the bf16 step's loss is not finite or its label counts differ")
        # (c) the eval step
        pred = torch.cat([r["pred"] for r in ranks], dim=1)
        share = float((pred != one_pred).double().mean())
        noise_share = float((noise_pred != one_pred).double().mean())
        pixel_gate = max(GRID28_RATIO * noise_share, GRID28_PIXEL_FLOOR)
        print(f"28(c) the eval step (float32) of the one-process step's weights on the "
              f"grid: the share of {pred.numel()} pixels whose class differs from one "
              f"process's {share!r}; {GRID28_NOISE} of noise on those weights moves "
              f"{noise_share!r} (gate {pixel_gate!r}); matrices "
              f"{[int(r['eval_cm'].sum()) for r in ranks]} pixels against "
              f"{int(one_cm.sum())}", flush=True)
        if pred.shape != one_pred.shape or share > pixel_gate or any(
                not torch.equal(r["eval_cm"], ranks[0]["eval_cm"]) for r in ranks) or \
                int(ranks[0]["eval_cm"].sum()) != int(one_cm.sum()):
            bad.append(f"(c) the grid's eval step: share {share}")
        # (d) the checkpoint
        print(f"28(d) the checkpoint: written by {[r['wrote'] for r in ranks]}, restored "
              f"bit-equal (model, Adam's state, step) {[r['restore_equal'] for r in ranks]}; "
              f"files {sorted(q.name for q in (tmp / 'chkpts').iterdir())}", flush=True)
        if [r["wrote"] for r in ranks] != [True, False] or \
                not all(r["restore_equal"] for r in ranks):
            bad.append("(d) the checkpoint round trip")
        # (f) memory
        peaks = [r.get("peak_bytes", 0) for r in ranks]
        mem = [pk / one_peak for pk in peaks]
        print(f"28(e) launches a rank in the float32 step {launches}; 28(f) peak memory "
              f"in the step: ranks {[pk / 2**30 for pk in peaks]} GiB, one process "
              f"{one_peak / 2**30!r} GiB, shares {mem} (gate {GRID28_MEMORY_SHARE}); "
              f"allocated at the forward's end: ranks "
              f"{[r.get('forward_end_bytes', 0) / 2**30 for r in ranks]} GiB, one process "
              f"{one_forward_end / 2**30!r} GiB; card {smi}", flush=True)
        if max(mem) > GRID28_MEMORY_SHARE:
            bad.append(f"(f) a rank's peak memory share {mem}")
        for part, label in (("graphs", "g"), ("decoders", "h")):
            bad += grid28_graphs_held(parts[part], [r[part] for r in ranks], g_one[part],
                                      g_noise[part], lr, smi, label)
        if bad:
            raise AssertionError("phase 28: " + "; ".join(bad))
        return {**{k: sum(n[k] for n in launches) for k in ("fu_hist", "fu_grad")},
                **{part: {name: {k: sum(r[part][name]["launches"][k] for r in ranks)
                                 for k in want} for name, (_, _, want) in graphs.items()}
                   for part, graphs in parts.items()}}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def grid28_graphs_held(graphs: dict, ranks: list, one: dict, noise: dict, lr: float,
                       smi: str, label: str = "g") -> list:
    """Phase 28(g)'s or 28(h)'s (`label`) prints and gates: each graph's
    grid ranks (`ranks`, their `grid28_graph` records by name) against its
    one-process run and the one-process run from weights moved by noise;
    the failures."""
    from miccai2021_cataract_semantic_segmentation_tpu_torch.kernels import KERNELS

    bad = []
    for name, (_, kind, want) in graphs.items():
        got = [r[name] for r in ranks]
        want = dict(dict.fromkeys(KERNELS, 0), **want)
        launches = [g["launches"] for g in got]
        if any(n != want for n in launches) or one[name]["launches"] != want:
            bad.append(f"({label}) {name}: launches {launches}, one process "
                       f"{one[name]['launches']} (want {want})")
        if kind == "train":
            far = step_distance(got[0], one[name], lr)
            ref = step_distance(noise[name], one[name], lr)
            gates = {k: max(GRID28_RATIO * ref[k], f) for k, f in GRID28_FLOOR.items()}
            equal = all(torch.equal(g["sd"][k], got[0]["sd"][k]) for g in got[1:]
                        for k in got[0]["sd"]) and all(g["scalars"] == got[0]["scalars"]
                                                       for g in got)
            one_peak = one[name].get("peak_bytes", 0)      # 0 in a CPU rehearsal
            mem = [g.get("peak_bytes", 0) / max(one_peak, 1) for g in got]
            print(f"28({label}) {name} on the (1, 2) grid, float32 step (TF32 off), batch "
                  f"{GRID28_GRAPH_BATCH}, against one process: {json.dumps(far)}; the "
                  f"noise's {json.dumps(ref)}; gates {json.dumps(gates)}, loss "
                  f"{GRID28_LOSS_TOL}, params within 2 lr; ranks equal {equal}; "
                  f"scalars {got[0]['scalars']} against {one[name]['scalars']}; launches "
                  f"a rank {launches}; peak memory ranks "
                  f"{[g.get('peak_bytes', 0) / 2**30 for g in got]} GiB, one process "
                  f"{one_peak / 2**30!r} GiB, shares {mem} (gate "
                  f"{GRID28_MEMORY_SHARE}); card {smi}", flush=True)
            if any(far[k] > g for k, g in gates.items()) or far["loss"] > GRID28_LOSS_TOL \
                    or far["params_max_over_lr"] > 2.0 + 1e-3 or not equal:
                bad.append(f"({label}) {name}'s float32 step against one process: {far}")
            if max(mem) > GRID28_MEMORY_SHARE:
                bad.append(f"({label}) {name}: a rank's peak memory share {mem}")
        else:
            pred = torch.cat([g["pred"] for g in got], dim=1)
            share = float((pred != one[name]["pred"]).double().mean())
            noise_share = float((noise[name]["pred"] != one[name]["pred"]).double().mean())
            d_loss = abs(got[0]["loss"] - one[name]["loss"])
            loss_gate = max(GRID28_RATIO * abs(noise[name]["loss"] - one[name]["loss"]),
                            GRID28_LOSS_TOL)
            pixel_gate = max(GRID28_RATIO * noise_share, GRID28_PIXEL_FLOOR)
            print(f"28({label}) {name}'s eval-loss step (float32) on the (1, 2) grid, batch "
                  f"{GRID28_GRAPH_BATCH}, against one process: loss {got[0]['loss']!r} "
                  f"against {one[name]['loss']!r} (difference {d_loss!r}, gate "
                  f"{loss_gate!r}); the share of {pred.numel()} pixels in another class "
                  f"{share!r} (noise {noise_share!r}, gate {pixel_gate!r}); launches a "
                  f"rank {launches}; card {smi}", flush=True)
            if pred.shape != one[name]["pred"].shape or share > pixel_gate or \
                    d_loss > loss_gate or any(g["loss"] != got[0]["loss"] for g in got) or \
                    any(not torch.equal(g["cm"], got[0]["cm"]) for g in got) or \
                    int(got[0]["cm"].sum()) != int(one[name]["cm"].sum()):
                bad.append(f"({label}) {name}'s eval-loss step: loss {d_loss}, share {share}")
        print(f"28({label}) {name} step times (CUDA events, median of 2, TF32 off): one process "
              f"{one[name].get('ms')!r} ms; grid ranks {[g.get('ms') for g in got]} ms (both on "
              f"one card); a step with the all-reduces timed: "
              f"{[g.get('timed_step_s') for g in got]} s, of it inside gloo's all-reduces "
              f"{[g.get('gloo_s') for g in got]} s over {[g.get('gloo_calls') for g in got]} "
              f"calls; card {smi}", flush=True)
    return bad


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
    wall = {}

    def phase(n, fn, *args, **kwargs):
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        wall[n] = time.perf_counter() - t
        print(f"phase {n} ({fn.__name__}) took {wall[n]!r} s wall", flush=True)
        return out

    b1 = phase(3, check_b1, dev)
    b2 = phase(4, check_b2, dev)
    phase(5, run_slice, dev, cfg)
    phase(6, card_vs_cpu, dev, cfg)
    launches = phase(7, run_train_slice, dev, cfg)
    phase(8, train_card_vs_cpu, dev, cfg)
    b1["launches"], b2["launches"] = launches["fu_hist"], launches["fu_grad"]
    b3 = phase(9, check_b3, dev)
    b4 = phase(10, check_b4, dev)
    b4f = phase("10b", check_b4f, dev)
    hr_launches = phase(11, run_cell, dev, hrnet_config(), "HRNetv2",
                        {"eval": {"bucket_hist": 1},
                         "train": {"bucket_hist": 1, "bucket_dlogits": 1}},
                        hrnet_batch_check)
    phase("11b", hrnet_route_memory, dev, hrnet_config())
    phase(12, train_card_vs_cpu, dev, hrnet_config(width=8), "HRNetv2-W8")
    b3["launches"] = hr_launches["bucket_hist"]
    b4["launches"] = hr_launches["bucket_grad"]
    b4f["launches"] = hr_launches["bucket_dlogits"]
    nchw = phase(13, phase13_nchw, dev)
    dl_launches = phase(14, run_cell, dev, deeplab_config(), "DeepLabv3",
                        {"eval": {"fu_hist": 1}, "train": {"fu_hist": 1, "fu_grad": 1}},
                        deeplab_batch_check)
    phase("14b", validate_deeplabv3plus, dev)
    v3_launches = phase(15, run_v3_route, dev, "DeepLabv3", deeplab_config())
    v3_launches.update({k: v for k, v in phase(
        "15b", run_v3_route, dev, "OCRNet", cfg).items() if k in V3_KERNELS["OCRNet"]})
    phase(16, train_card_vs_cpu, dev, deeplab_config(), "DeepLabv3")
    for name, record in nchw.items():
        record["launches"] = v3_launches[name]
    protos = phase(17, phase17_fused_upsample, dev)
    upn_launches = phase(18, run_cell, dev, upernet_config(), "UPerNet",
                         {"eval": {"fu_hist": 1}, "train": {"fu_hist": 1, "fu_grad": 1}},
                         upernet_batch_check)
    phase(19, train_card_vs_cpu, dev, upernet_config(), "UPerNet")
    phase(20, phase20_served, dev)
    trainer_launches = phase(21, phase21_train_from_disk, dev)
    b1["trainer_train_launches"] = trainer_launches["fu_hist"]
    b2["trainer_train_launches"] = trainer_launches["fu_grad"]
    import tempfile
    with tempfile.TemporaryDirectory(prefix="cadis_semi_tree_") as tree:
        data = write_semi_tree(pathlib.Path(tree) / "data")
        zoo = phase(22, phase22_contrastive_and_zoo, dev, data)
        semi = phase(23, phase23_semi, dev, data)
        graphs = phase(24, phase24_remaining_graphs, dev, data)
        extras = phase(25, phase25_served_extras, dev, data)
        parallel = phase(26, phase26_parallel, dev, data)
    b1["parallel_launches"], b2["parallel_launches"] = parallel["fu_hist"], parallel["fu_grad"]
    twins = phase(27, phase27_tools, dev)
    b1["twins_launches"], b2["twins_launches"] = twins["fu_hist"], twins["fu_grad"]
    grid = phase(28, phase28_spatial, dev)
    b1["grid_launches"], b2["grid_launches"] = grid["fu_hist"], grid["fu_grad"]
    # phase 28(g) and 28(h): each graph's step summed over the two ranks
    for rec, key in ((b1, "fu_hist"), (b2, "fu_grad"), (b3, "bucket_hist"),
                     (b4f, "bucket_dlogits")):
        for part, name in (("graphs", "grid_graph_launches"),
                           ("decoders", "grid_decoder_launches")):
            rec[name] = {g: n[key] for g, n in grid[part].items() if n.get(key)}
    for rec, key in ((b1, "fu_hist"), (b2, "fu_grad")):
        rec["contrastive_launches"] = zoo["contrastive"][key]
        rec["zoo_launches"] = zoo["zoo"][key]
    for rec, key, k in ((b3, "bucket_hist", "b3"), (b4f, "bucket_dlogits", "b4f")):
        rec["semi_launches"] = semi["launches"][key]
        rec["semi_half_ms"] = semi["half"][f"{k}_ms"]
        rec["semi_half_plain_ms"] = semi["half"][f"{k}_plain_ms"]
    # phase 24: each graph's launches over validate (one batch) and
    # train_steps (two steps); PointRend's over its CLI run
    for rec, key in ((b1, "fu_hist"), (b2, "fu_grad"), (b3, "bucket_hist"),
                     (b4f, "bucket_dlogits")):
        counts = {name: g["validate_launches"][key] + g["train_launches"][key]
                  for name, g in graphs["graphs"].items()}
        counts["PointRend (CLI)"] = graphs["pointrend"]["launches"][key]
        rec["phase24_launches"] = {k: v for k, v in counts.items() if v}
    # phase 25: the semi recipe fed by the training videos' pool
    for rec, key in ((b1, "fu_hist"), (b3, "bucket_hist"), (b4f, "bucket_dlogits")):
        rec["video_pool_launches"] = extras["pool"]["launches"][key]

    print(f"phases' wall seconds: {json.dumps(wall)}; total {sum(wall.values())!r}")
    print("kernels B1 fu_hist, B2 fu_grad, B3 bucket_hist, B4 bucket_grad, "
          "B4f bucket_dlogits, B5 nchw_hist, B6 nchw_grad, B7 nchw1_hist, B8 "
          "nchw1_grad, P1 fused_upsample and P2 fused_downsample: ported (CUDA "
          "C++, sm_90a); launches counted over train_steps (B1/B2: OCRNet "
          f"{launches['fu_hist']}/{launches['fu_grad']}, DeepLabv3 "
          f"{dl_launches['fu_hist']}/{dl_launches['fu_grad']} and UPerNet "
          f"{upn_launches['fu_hist']}/{upn_launches['fu_grad']}, B3/B4/B4f: "
          "HRNetv2, whose backward runs B4f and not B4 (B4 stays behind the "
          "per-row `bucket_lovasz_per_class`), "
          "B5/B6: OCRNet on the v3 route, B7/B8: DeepLabv3 on the v3 route), "
          "over the flagship's Trainer.train from disk (B1/B2: "
          f"{trainer_launches['fu_hist']}/{trainer_launches['fu_grad']}, "
          "'trainer_train_launches'), over the contrastive recipe and the loss "
          f"zoo through the CLI (B1/B2: {zoo['contrastive']['fu_hist']}/"
          f"{zoo['contrastive']['fu_grad']} and {zoo['zoo']['fu_hist']}/"
          f"{zoo['zoo']['fu_grad']}), over the semi-supervised Trainer.train "
          f"(B3/B4f: {semi['launches']['bucket_hist']}/"
          f"{semi['launches']['bucket_dlogits']}, 'semi_launches'), over phase "
          f"24's graphs (B3/B4f: PointRend through the CLI "
          f"{graphs['pointrend']['launches']['bucket_hist']}/"
          f"{graphs['pointrend']['launches']['bucket_dlogits']}, FCN and UNet; B1/B2: "
          "OCRNet-R18/R34/HRNet-W18 and UPerNet on Inception-v3, ResNeXt-50 and "
          "WideResNet-50; 'phase24_launches') "
          "over the semi recipe whose pool is the training videos (phase 25: "
          f"B1/B3/B4f {extras['pool']['launches']['fu_hist']}/"
          f"{extras['pool']['launches']['bucket_hist']}/"
          f"{extras['pool']['launches']['bucket_dlogits']}, 'video_pool_launches'; 0 on "
          "TTA, video inference and the served export), over the bucket twin of "
          f"tools/trajectory_twins.py (phase 27: B1/B2 {twins['fu_hist']}/"
          f"{twins['fu_grad']}, 'twins_launches'; 0 on the sort twin, reproduce_paper "
          "and the data tools), over the (1, 2) spatial grid's float32 step (phase 28: "
          f"B1/B2 {grid['fu_hist']}/{grid['fu_grad']} summed over the two ranks, "
          "'grid_launches'; the other graphs' steps on the grid, summed over the ranks, "
          f"{json.dumps(grid['graphs'])}, 'grid_graph_launches'; the decoders' steps "
          f"{json.dumps(grid['decoders'])}, 'grid_decoder_launches') "
          "and over the prototype counterpart's main (P1/P2: "
          f"{protos['fused_upsample']['launches']}/"
          f"{protos['fused_downsample']['launches']}, one each per check and "
          "per timed call; 0 on every model step of phases 5-18)")
    print(json.dumps({"kernels": [b1, b2, b3, b4, b4f] + [
        nchw[k] for k in ("nchw_hist", "nchw_grad", "nchw1_hist", "nchw1_grad")]
        + [protos["fused_upsample"], protos["fused_downsample"]]}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank26a"]:       # phase 26(a)'s worker, under torchrun
        sys.path.insert(0, ROOT)
        sys.exit(rank26a(sys.argv[2]))
    sys.exit(main())
