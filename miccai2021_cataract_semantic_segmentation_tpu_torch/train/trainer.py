"""Trainer: the served half (inference and validation) of the JAX package's
train/trainer.py.

One object holds the run: its directory and checkpoints, the frame table
and its split, the datasets, the model, the loss, the eval steps and the
writers. `validate(epoch)` runs the validation set in tail-padded, masked
batches (the loss over the full batches only, the confusion matrix in
int64 on the host), keeps the best-mIoU and periodic checkpoints and
rewrites info.json; `infer()` times the eval step over the set after one
warm-up batch and writes its metrics and frames/s to info.json. The
device is "cuda" unless the caller passes device="cpu" (the tests).

Not ported yet, and raising with their ROADMAP Queue A items: `train()`
(item 8, with the samplers and exact resume), TTA (item 13), the Ensemble
(item 12), the MoCo-pretrained backbone and the semi-supervised mode
(item 11).
"""
from __future__ import annotations

import datetime
import pathlib
import time

import numpy as np
import torch

from miccai2021_cataract_semantic_segmentation_tpu_torch import resolve_device, taxonomy
from miccai2021_cataract_semantic_segmentation_tpu_torch.data import png
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (
    load_frame_table, split_dataframes)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import (
    DECODED, SegDataset)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import (
    assemble_batch, epoch_iterator, eval_batches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import build_model
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import (
    mean_iou_breakdown, normalise_confusion_matrix, pixel_accuracy)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.remap import mask_to_colormap
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.loggers import (
    TBLogger, confusion_matrix_figure)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    EvalSpec, make_eval_loss_step, make_eval_step)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP Queue A "
                               f"item {item})")


def _breakdown(cm: np.ndarray, task: int) -> dict:
    bd = mean_iou_breakdown(cm, task)
    pa, pac = pixel_accuracy(cm)
    return {"miou": float(bd["miou"]),
            "miou_instruments": float(bd.get("miou_instruments", 0.0)),
            "miou_anatomies": float(bd.get("miou_anatomies", 0.0)),
            "miou_rare": float(bd.get("miou_rare", 0.0)),
            "pa": float(pa), "pac": float(pac),
            "per_class": np.asarray(bd["per_class"])}


class Trainer:
    def __init__(self, config: dict, datasets=None, *,
                 device: str | torch.device = "cuda"):
        """`datasets`: optional (train_dataset, valid_dataset, train_df,
        valid_df) override for synthetic and test runs."""
        self.device = resolve_device(device)
        self.config = config
        self.task = int(config["data"]["experiment"])
        self.mode = config.get("mode", "training")
        self.seed = int(config.get("seed", 0))
        graph = config.get("graph", {})
        # an empty loss section is cross-entropy, a nameless {"losses": ...}
        # the LossWrapper (build_loss)
        loss_cfg = config.get("loss") or {}
        if graph.get("model") == "Ensemble" or config.get("manager") == "Ensemble":
            raise _not_ported("the Ensemble", "12")
        if loss_cfg.get("name") == "SemiSupervisedLoss":
            raise _not_ported("the semi-supervised mode", "11")
        if graph.get("ss_pretrained"):
            raise _not_ported("the MoCo-v2 pretrained backbone", "11")

        self.run_id = config.get("run_id") or "{}_e{}__{}".format(
            datetime.datetime.now().strftime("%Y%m%d_%H%M%S"), self.task,
            config.get("name", "run"))
        self.run_dir = pathlib.Path(config.get("log_path", "logs")) / self.run_id
        self.ckpt_dir = self.run_dir / "chkpts"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)

        # data -------------------------------------------------------------
        dcfg = config["data"]
        # raises on a host transform (not ported); validation pads where
        # "pad" is listed, as the JAX Trainer derives its eval spec
        self.pipeline = build_transform_pipeline(
            dcfg.get("transforms", ["pad"]), dcfg.get("transform_values", {}),
            self.task)
        if datasets is not None:
            self.train_set, self.valid_set, self.train_df, self.valid_df = datasets
        else:
            df = load_frame_table(dcfg.get("data_csv"), config.get("data_path"))
            self.train_df, self.valid_df = split_dataframes(
                df, dcfg.get("split", 1), mode=self.mode,
                use_relabeled=dcfg.get("use_relabeled", False),
                blacklist=dcfg.get("blacklist", True),
                random_split=dcfg.get("random_split"), seed=self.seed)
            self.train_set = SegDataset(self.train_df, self.task,
                                        config.get("data_path"),
                                        preload=dcfg.get("preload", False))
            self.valid_set = SegDataset(self.valid_df, self.task,
                                        config.get("data_path"))
        # batched eval is metric-exact at any batch size (tail padding and
        # masking, validate()): 8 on the card, 1 (the reference's loop) on
        # the CPU; an explicit config wins
        vbs = config.get("valid_batch_size")
        self.valid_batch_size = int(vbs) if vbs else \
            (8 if self.device.type == "cuda" else 1)

        # model, loss, eval steps ------------------------------------------
        self.precision = config.get("precision", "bf16")
        self.model = build_model(graph, self.task, device=self.device, seed=self.seed)
        self.loss_fn = build_loss(loss_cfg, self.task, self.device)
        if config.get("torch_checkpoint"):
            self._load_torch_checkpoint(config["torch_checkpoint"])
        spec = EvalSpec(pad=True, normalise=self.pipeline.device.normalise) \
            if self.pipeline.valid_pad else None
        self.num_classes = taxonomy.TASK_NUM_CLASSES[self.task]
        self.eval_step = make_eval_step(spec, self.num_classes, self.device,
                                        self.precision)
        self.eval_loss_step = make_eval_loss_step(self.loss_fn, spec, self.device,
                                                  self.precision)

        # bookkeeping ------------------------------------------------------
        self.state = None          # the train state comes with train()
        self.debugging = bool(config.get("debugging", False))
        self.valid_writer = TBLogger(self.run_dir / "valid")
        self.global_step = 0
        self.start_epoch = 0
        self.best_miou = 0.0
        self.best_loss = float("inf")
        self.metrics: dict = {}
        self.log_every_n_epochs = int(config.get("log_every_n_epochs", 100))

    def close(self) -> None:
        self.valid_writer.close()

    def _load_torch_checkpoint(self, path) -> None:
        """Load a reference `.pt` (a run's chkpt_best.pt, or a bare state
        dict) into the model, strictly."""
        ckpt.load_model_state(self.model, ckpt.load_torch_checkpoint(path), str(path))
        print(f"[{self.run_id}] loaded torch checkpoint {path}")

    def train(self):
        raise _not_ported("training through the Trainer (its samplers, host "
                          "transforms and exact resume)", "8")

    # ------------------------------------------------------------ validate
    def validate(self, epoch: int) -> dict:
        """Full-coverage batched validation: every record counts in the
        confusion matrix at any valid_batch_size (the tail batch repeats the
        last record and its padded rows are masked with label 255, which
        counts nowhere); the loss is the mean over the full batches only.
        The batch size clamps to the set's size, so a small set's one batch
        is exact."""
        n = len(self.valid_set)
        bs = min(self.valid_batch_size, n)
        batches, n_pad = eval_batches(n, bs)
        max_imgs = int(self.config.get("max_valid_imgs", 10))
        cm_total = np.zeros((self.num_classes, self.num_classes), np.int64)
        loss_total, n_batches, logged = 0.0, 0, 0
        for bi, (images, labels, _) in enumerate(epoch_iterator(
                self.valid_set, batches, self.device, prefetch=2)):
            if n_pad and bi == len(batches) - 1:
                labels[bs - n_pad:] = 255
                logits, lbl, cm = self.eval_step(self.model, images, labels)
            else:
                logits, lbl, cm, loss = self.eval_loss_step(self.model, images,
                                                            labels, epoch)
                loss_total += float(loss)
                n_batches += 1
            cm_total += cm.cpu().numpy().astype(np.int64)
            if logged < max_imgs:
                self._log_valid_image(images[0], lbl[0], logits[0], epoch, logged)
                logged += 1
        valid_loss = loss_total / max(n_batches, 1)
        bd = _breakdown(cm_total, self.task)
        miou = bd["miou"]
        self.metrics = {
            "epoch": epoch, "valid_loss": valid_loss,
            **{k: v for k, v in bd.items() if k != "per_class"},
            "per_class_iou": bd["per_class"].tolist(),
            "confusion_matrix": cm_total.tolist(),
        }
        self.valid_writer.scalars(
            {k: v for k, v in self.metrics.items() if isinstance(v, float)},
            self.global_step, prefix="metrics/")
        for mode in ("row", "col"):
            fig = confusion_matrix_figure(normalise_confusion_matrix(cm_total, mode),
                                          self.task)
            self.valid_writer.figure(f"confusion_matrix/{mode}", fig,
                                     self.global_step)
        print(f"[{self.run_id}]   valid: loss {valid_loss:.4f} miou {miou:.4f} "
              f"(instr {bd['miou_instruments']:.4f} "
              f"anat {bd['miou_anatomies']:.4f} rare {bd['miou_rare']:.4f})")
        # best-mIoU and periodic checkpoints
        if miou > self.best_miou:
            self.best_miou = miou
            ckpt.save_checkpoint(self.ckpt_dir, "best", self.model, epoch,
                                 self.best_miou, self.best_loss, self.state)
        if valid_loss < self.best_loss:
            self.best_loss = valid_loss
        if (epoch + 1) % self.log_every_n_epochs == 0:
            ckpt.save_checkpoint(self.ckpt_dir, "last", self.model, epoch,
                                 self.best_miou, self.best_loss, self.state)
        ckpt.write_info_json(self.run_dir, self.config, self.metrics)
        return self.metrics

    def _log_valid_image(self, image, lbl, logits, step, i) -> None:
        """img|gt|pred triptych of one record (the reference's to_comb_image);
        also a PNG under <run_dir>/debug/ when `debugging`."""
        img_u8 = image.cpu().numpy()
        lbl = lbl.cpu().numpy()
        pred = logits.argmax(dim=0).cpu().numpy()
        h = min(img_u8.shape[0], lbl.shape[0])
        comb = np.concatenate([
            img_u8[:h], mask_to_colormap(lbl[:h], self.task),
            mask_to_colormap(pred[:h], self.task)], axis=1)
        self.valid_writer.image(f"valid_img_{i}", comb, step)
        if self.debugging:
            dbg = self.run_dir / "debug"
            dbg.mkdir(exist_ok=True)
            png.write_png(dbg / f"valid_e{step:03d}_{i}.png", comb)

    # ------------------------------------------------------------ inference
    def load_checkpoint(self, which: str = "best", run_id: str | None = None) -> dict:
        """Load chkpt_<which>.pt of this run, or of run `run_id` under the
        same log_path (a published run directory), into the model."""
        ckpt_dir = self.ckpt_dir if run_id is None else \
            pathlib.Path(self.config.get("log_path", "logs")) / run_id / "chkpts"
        meta = ckpt.restore_checkpoint(ckpt_dir, which, self.model, self.state)
        self.start_epoch = meta["epoch"] + 1
        self.best_miou = meta["best_miou"]
        self.best_loss = meta["best_loss"]
        self.global_step = meta["global_step"]
        return meta

    def infer(self, tta: bool | None = None) -> dict:
        """Test/validation inference over the valid set: one warm-up batch,
        then the timed loop; `frames_per_sec` counts the real records over
        the host time to the last batch's results (after a device
        synchronise), the warm-up excluded."""
        tta = self.config.get("tta", False) if tta is None else tta
        if tta:
            raise _not_ported("test-time augmentation", "13")
        n = len(self.valid_set)
        bs = self.valid_batch_size
        batches, n_pad = eval_batches(n, bs)
        max_imgs = int(self.config.get("max_valid_imgs", 10))
        log_at = set(np.round(np.linspace(0, len(batches) - 1,
                                          max_imgs)).astype(int).tolist())
        wi, wl, _ = assemble_batch(self.valid_set, batches[0])
        w_logits, _, _ = self.eval_step(self.model, wi, wl)
        w_logits[0].argmax(dim=0).cpu()
        self._synchronize()
        decoded0 = dict(DECODED)
        cm_total = np.zeros((self.num_classes, self.num_classes), np.int64)
        t0 = time.perf_counter()
        for bi, (images, labels, _) in enumerate(epoch_iterator(
                self.valid_set, batches, self.device, prefetch=2)):
            if n_pad and bi == len(batches) - 1:
                labels[bs - n_pad:] = 255      # mask the repeated records
            logits, lbl, cm = self.eval_step(self.model, images, labels)
            cm_total += cm.cpu().numpy().astype(np.int64)
            if bi in log_at:
                self._log_valid_image(images[0], lbl[0], logits[0],
                                      self.global_step, bi)
        self._synchronize()
        dt = time.perf_counter() - t0
        bd = _breakdown(cm_total, self.task)
        results = {**{k: v for k, v in bd.items() if k != "per_class"},
                   "frames_per_sec": n / dt,
                   "confusion_matrix": cm_total.tolist(),
                   "decoded": {k: DECODED[k] - decoded0[k] for k in DECODED},
                   "device": str(self.device), "valid_batch_size": bs}
        print(f"[{self.run_id}] infer: " + ", ".join(
            f"{k} {v}" for k, v in results.items() if k != "confusion_matrix"))
        ckpt.write_info_json(self.run_dir, self.config, results)
        return results

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
