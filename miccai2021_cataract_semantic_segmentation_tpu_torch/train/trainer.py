"""Trainer: the port of the JAX package's train/trainer.py.

One object holds the run: its directory and checkpoints, the frame table
and its split, the datasets, the model, the loss, the train state (the
optimiser and its LR schedule over epochs of varying length), the train
and eval steps and the writers. `train()` runs the epochs: each epoch's
index batches from the loader its schedule names (default, repeat-factor,
oversampling, weighted-random or adaptive batching; data/samplers.py),
the train step over them with the confusion matrix and the loss kept on
the card and read back once an epoch, the step scalars, `validate(epoch)`,
and at the end the `last` checkpoint (with the optimiser and the step) and
the index histogram. A resume (`load_checkpoint("last")`) replays the
index streams of the epochs already trained, so the rest see the batches
an uninterrupted run sees. `validate(epoch)` runs the validation set in
tail-padded, masked batches (the loss over the full batches only, the
confusion matrix in int64 on the host), keeps the best-mIoU and periodic
checkpoints and rewrites info.json; `infer()` times the eval step over the
set after one warm-up batch and writes its metrics and frames/s to
info.json. The device is "cuda" unless the caller passes device="cpu"
(the tests).

A train pipeline's host transforms (data/transforms.py) run on each
sample as its batch is assembled, from a generator seeded with the seed
plus the epoch. With the SemiSupervisedLoss the Trainer runs in semi mode,
as the JAX Trainer does: each batch is half labelled frames and half
frames of an unlabelled pool (the fifth element of `datasets`) drawn with
replacement after the epoch's labelled batches, the train step labels the
second half with the model's own confident predictions
(train/steps.py:`teacher_labels`), an epoch covers the labelled set at
half the batch size, the index histogram counts labelled frames only and
the validation loss is the labelled loss alone. `graph.ss_pretrained:
"moco"` initialises the backbone from a MoCo-v2 checkpoint. A PointRend
graph trains with its point loss (train/steps.py).

With the graph `{"model": "Ensemble", "members": {...}, "merge": ...}`
(or `manager: "Ensemble"` with `members` and `merge` at the top level) the
Trainer runs in inference mode only, as the JAX Trainer does: each member
is restored from its run's `chkpt_best.pt` (models/ensemble.py), the eval
preprocessing pads without normalising (the members normalise where they
were trained so), and `infer()` counts the merged probabilities' argmax.

`infer(tta=True)` (or the config's `tta`) runs the reference's flip x
multi-scale test-time augmentation (`tta_scales`, default 0.75, 1, 1.5,
1.75, 2) in place of the eval step: the matrix and the triptychs come from
the merged probabilities. In semi mode without a given pool, the pool is
the training split's surgery videos under `data_path`
(data/semi.py:unlabeled_from_videos).
"""
from __future__ import annotations

import contextlib
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
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.semi import (
    SemiSupervisedView, unlabeled_from_videos)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.samplers import (
    AdaptiveBatchSampler, RepeatFactorSampler, oversample_indices,
    weighted_random_epoch, weighted_random_weights)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (
    build_transform_pipeline)
from miccai2021_cataract_semantic_segmentation_tpu_torch.losses import build_loss
from miccai2021_cataract_semantic_segmentation_tpu_torch.models import (
    build_ensemble, build_model)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.metrics import (
    mean_iou_breakdown, normalise_confusion_matrix, pixel_accuracy)
from miccai2021_cataract_semantic_segmentation_tpu_torch.ops.remap import mask_to_colormap
from miccai2021_cataract_semantic_segmentation_tpu_torch.train import checkpoint as ckpt
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.loggers import (
    StepTimer, TBLogger, confusion_matrix_figure, index_histogram_figure,
    profile_steps)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import make_schedule
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import create_train_state
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (
    TTA_SCALES, EvalSpec, make_eval_loss_step, make_eval_step, make_train_step,
    make_tta_step)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import (
    has_point_head, train_metrics_source)


def _is_resnet_tensor(key: str) -> bool:
    """Whether a torchvision ResNet state-dict key names a convolution's
    weight or bias or a BatchNorm's weight, bias or running statistics
    (the JAX package's `port_torch._resnet_flax_path`; other tensors, such
    as `num_batches_tracked`, are not copied)."""
    parts = key.split(".")
    if len(parts) < 2:
        return False
    leaf, module = parts[-1], parts[-2]
    if module.isdigit() and len(parts) >= 3 and parts[-3] == "downsample":
        module = f"downsample_{module}"
    if module.startswith("conv"):
        return leaf in ("weight", "bias")
    if module == "downsample_0":
        return leaf == "weight"
    if module.startswith("bn") or module == "downsample_1":
        return leaf in ("weight", "bias", "running_mean", "running_var")
    return False


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
        valid_df[, unlabeled_dataset]) override for synthetic and test runs;
        semi mode needs the fifth, the unlabelled pool."""
        self.device = resolve_device(device)
        self.config = config
        self.task = int(config["data"]["experiment"])
        self.mode = config.get("mode", "training")
        self.seed = int(config.get("seed", 0))
        graph = config.get("graph", {})
        # an empty loss section is cross-entropy, a nameless {"losses": ...}
        # the LossWrapper (build_loss)
        loss_cfg = config.get("loss") or {}
        self.ensemble = graph.get("model") == "Ensemble" or \
            config.get("manager") == "Ensemble"
        if self.ensemble and self.mode != "inference":
            raise ValueError("the Ensemble runs in inference mode only")
        self.semi = (loss_cfg.get("name") == "SemiSupervisedLoss"
                     and self.mode == "training")

        self.run_id = config.get("run_id") or "{}_e{}__{}".format(
            datetime.datetime.now().strftime("%Y%m%d_%H%M%S"), self.task,
            config.get("name", "run"))
        self.run_dir = pathlib.Path(config.get("log_path", "logs")) / self.run_id
        self.ckpt_dir = self.run_dir / "chkpts"
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)

        # data -------------------------------------------------------------
        dcfg = config["data"]
        self.pipeline = build_transform_pipeline(
            dcfg.get("transforms", ["pad"]), dcfg.get("transform_values", {}),
            self.task)
        self.unlabeled_set = None
        if datasets is not None:
            self.train_set, self.valid_set, self.train_df, self.valid_df = datasets[:4]
            if len(datasets) == 5:
                self.unlabeled_set = datasets[4]
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
        self.batch_size = int(dcfg.get("batch_size", 8))
        if self.semi:
            if self.batch_size % 2:
                raise ValueError(
                    "semi-supervised mode splits each batch half/half "
                    "(SemiSupervisedLoss.py:44-84); batch_size must be even, "
                    f"got {self.batch_size}")
            if self.unlabeled_set is None:
                self.unlabeled_set = unlabeled_from_videos(config.get("data_path"),
                                                           self.train_df)
            self._iter_set = SemiSupervisedView(
                self.train_set, self.unlabeled_set, taxonomy.TASK_NUM_CLASSES[self.task])
        else:
            self._iter_set = self.train_set
        # labelled samples per batch: a semi batch is [labelled | unlabelled]
        self.lab_batch_size = self.batch_size // 2 if self.semi else self.batch_size

        # the per-epoch loader schedule (BaseManager.py:202-213): a loader's
        # [start] runs it from `start` to the end, [start, end] up to `end`
        self.epochs = int(config["train"].get("epochs", 50))
        self.train_schedule = {e: "default" for e in range(self.epochs)}
        for loader in ("adaptive_batching", "oversampling", "weighted_random",
                       "repeat_factor"):
            span = list(dcfg.get(loader, [0, 0]))
            if len(span) == 1:
                span.append(self.epochs)
            for e in range(*span):
                if 0 <= e < self.epochs:
                    self.train_schedule[e] = loader
        self._samplers: dict = {}
        self.steps_per_epoch = max(1, len(self.train_set) // self.lab_batch_size)
        # an epoch's length is its loader's own (a repeat-factor epoch
        # about sum r(I) / bs batches, an oversampling one (n + extra) /
        # bs), and the LR schedule counts those lengths
        self.epoch_steps = [self._expected_steps(self.train_schedule[e])
                            for e in range(self.epochs)]

        # bookkeeping ------------------------------------------------------
        self.train_writer = TBLogger(self.run_dir / "train")
        self.valid_writer = TBLogger(self.run_dir / "valid")
        self.global_step = 0
        self.start_epoch = 0
        self.best_miou = 0.0
        self.best_loss = float("inf")
        self.metrics: dict = {}
        self.train_metrics: dict = {}
        self.ind_counts = np.zeros(len(self.train_set), np.int64)
        self.epoch_batches: dict[int, np.ndarray] = {}
        self.adaptive_sampler: AdaptiveBatchSampler | None = None
        self.log_every_n_epochs = int(config.get("log_every_n_epochs", 100))
        self.log_every_n_steps = int(config.get("log_every_n_steps", 50))

        # model, loss, eval steps ------------------------------------------
        self.precision = config.get("precision", "bf16")
        self.num_classes = taxonomy.TASK_NUM_CLASSES[self.task]
        if self.ensemble:
            self._init_ensemble(graph or {k: config[k] for k in ("members", "merge")
                                          if k in config})
            return
        self.model = build_model(graph, self.task, device=self.device, seed=self.seed)
        self.loss_fn = build_loss(loss_cfg, self.task, self.device)
        if graph.get("ss_pretrained"):
            self._load_ss_pretrained(graph["ss_pretrained"])
        if config.get("torch_checkpoint"):
            self._load_torch_checkpoint(config["torch_checkpoint"])
        # validation pads where "pad" is listed and "crop" is not, and
        # normalises where "pad" and "torchvision_normalise" are: the JAX
        # Trainer's eval spec is its train device spec where "pad" is listed
        spec = EvalSpec(pad=self.pipeline.device.pad,
                        normalise=self.pipeline.device.normalise) \
            if self.pipeline.valid_pad else None
        self.eval_spec = spec
        self.eval_step = make_eval_step(spec, self.num_classes, self.device,
                                        self.precision)
        # validation batches are fully labelled: in semi mode their loss is
        # the labelled term's loss alone
        valid_loss_fn = build_loss(dict(loss_cfg.get("labeled", {"name": "CrossEntropyLoss"})),
                                   self.task, self.device) if self.semi else self.loss_fn
        self.eval_loss_step = make_eval_loss_step(valid_loss_fn, spec, self.device,
                                                  self.precision, self.num_classes)
        # the train state in every mode, so that load_checkpoint("last")
        # restores the optimiser and the step
        self.schedule = make_schedule(config["train"], self.epoch_steps)
        self.state = create_train_state(self.model, config["train"], self.schedule)
        self.num_params = sum(p.numel() for p in self.model.parameters())
        self.debugging = bool(config.get("debugging", False))
        semi_spec = {"threshold": float(loss_cfg.get("pseudo_threshold", 0.9)),
                     "ignore_id": self.num_classes} if self.semi else None
        self.train_step = make_train_step(
            self.loss_fn, self.pipeline.device, self.task, device=self.device,
            precision=self.precision, train_metrics=train_metrics_source(config),
            seed=self.seed, debug_pred=self.debugging, semi=semi_spec,
            has_point_head=has_point_head(graph))

    def _init_ensemble(self, graph: dict) -> None:
        """Inference-only Ensemble (the reference's Ensemble_Manager.py:7-16
        and BaseManager.infer): the members of `graph` restored from
        `<log_path>/<ckpt>/chkpts/chkpt_best.pt`, the eval step on their
        merged probabilities, the pad alone as preprocessing."""
        self.model = build_ensemble(graph, self.task, self.config.get("log_path", "logs"),
                                    self.device)
        spec = EvalSpec(pad=True) if self.pipeline.valid_pad else None
        self.eval_spec = spec
        self.eval_step = make_eval_step(spec, self.num_classes, self.device,
                                        self.precision)
        self.state = None
        self.num_params = sum(p.numel() for p in self.model.parameters())
        self.debugging = bool(self.config.get("debugging", False))

    def close(self) -> None:
        self.train_writer.close()
        self.valid_writer.close()

    def _load_ss_pretrained(self, kind: str) -> None:
        """Initialise the backbone (`enc_model` of an EncDec) from the
        MoCo-v2 checkpoint `<ss_pretrained_path>/moco/
        moco_v2_800ep_pretrain.pth.tar` (BaseManager.py:532-571): the
        `module.encoder_q.` prefix stripped, the `fc` head dropped, every
        convolution and BatchNorm tensor of a torchvision ResNet copied
        into the model under the prefix, a name or shape the model lacks
        refused."""
        if kind != "moco":
            raise ValueError(f"ss_pretrained '{kind}' not supported (moco only)")
        path = pathlib.Path(self.config["ss_pretrained_path"]) / "moco" / \
            "moco_v2_800ep_pretrain.pth.tar"
        prefix = "enc_model" if self.config["graph"].get("model") == "EncDec" \
            else "backbone"
        own = self.model.state_dict()
        updates = {}
        for key, value in ckpt.load_torch_checkpoint(path).items():
            if key.startswith("module.encoder_q."):
                key = key[len("module.encoder_q."):]
            if key.startswith("fc.") or not _is_resnet_tensor(key):
                continue
            target = f"{prefix}.{key}"
            if target not in own:
                raise KeyError(f"MoCo tensor {key} has no place {target} in the model")
            if tuple(own[target].shape) != tuple(value.shape):
                raise ValueError(f"MoCo tensor {key}: shape {tuple(value.shape)}, "
                                 f"the model's {tuple(own[target].shape)}")
            updates[target] = value
        with torch.no_grad():
            for target, value in updates.items():
                own[target].copy_(value)
        print(f"[{self.run_id}] initialised {prefix} from MoCo-v2 "
              f"({len(updates)} tensors)")

    def _load_torch_checkpoint(self, path) -> None:
        """Load a reference `.pt` (a run's chkpt_best.pt, or a bare state
        dict) into the model, strictly."""
        ckpt.load_model_state(self.model, ckpt.load_torch_checkpoint(path), str(path))
        print(f"[{self.run_id}] loaded torch checkpoint {path}")

    # ---------------------------------------------------------------- data
    def _get_rf_sampler(self) -> RepeatFactorSampler:
        s = self._samplers.get("repeat_factor")
        if s is None:
            s = self._samplers["repeat_factor"] = RepeatFactorSampler(
                self.train_df, self.config["data"]["repeat_factor_freq_thresh"],
                self.task, blacklist=self.config["data"].get("blacklist", True),
                seed=self.seed + 1)
        return s

    def _get_oversampling_extra(self) -> np.ndarray:
        extra = self._samplers.get("oversampling")
        if extra is None:
            extra = self._samplers["oversampling"] = oversample_indices(
                self.train_df, self.task,
                self.config["data"].get("oversampling_preset", "default"),
                self.config["data"].get("oversampling_frac", 0.2))
        return extra

    def _expected_steps(self, mode: str) -> int:
        """The batches of one epoch of loader `mode` (in semi mode, over the
        labelled set at half the batch size)."""
        n, bs = len(self.train_set), self.lab_batch_size
        if mode == "repeat_factor":
            return max(1, int(self._get_rf_sampler().repeat_factors.sum()) // bs)
        if mode == "oversampling":
            return max(1, (n + len(self._get_oversampling_extra())) // bs)
        return max(1, n // bs)

    def _epoch_batches(self, epoch: int, np_rng: np.random.Generator) -> np.ndarray:
        """(steps, batch_size) indices of `epoch` from its scheduled loader;
        `np_rng` is the run's generator (the default, oversampling and
        weighted-random loaders draw from it), the other loaders keep
        their own. In semi mode the loader gives the labelled half of each
        batch, and the unlabelled half is drawn from `np_rng` after it,
        uniformly with replacement, as indices of `_iter_set` past the
        labelled set."""
        mode = self.train_schedule.get(epoch, "default")
        n, bs = len(self.train_set), self.lab_batch_size
        if mode == "repeat_factor":
            batches = self._get_rf_sampler().epoch_batches(bs)
        elif mode == "oversampling":
            idx = np_rng.permutation(np.concatenate(
                [np.arange(n), self._get_oversampling_extra()]))
            batches = idx[: (len(idx) // bs) * bs].reshape(-1, bs)
        elif mode == "weighted_random":
            w = self._samplers.get("weighted_random")
            if w is None:
                w = self._samplers["weighted_random"] = weighted_random_weights(
                    self.train_df, self.task,
                    self.config["data"].get("weighted_random_mode", "v1"))
            idx = weighted_random_epoch(w, n, np_rng)
            batches = idx[: (n // bs) * bs].reshape(-1, bs)
        elif mode == "adaptive_batching":
            if self.adaptive_sampler is None:
                d = self.config["data"]
                self.adaptive_sampler = AdaptiveBatchSampler(
                    self.train_df, self.task, bs, d.get("adaptive_sel_size", 10),
                    dist_type=d.get("adaptive_dist_type", "1-**2"),
                    iou_update=d.get("adaptive_iou_update", 1), seed=self.seed + 2)
            batches = self.adaptive_sampler.epoch_batches()
        else:
            idx = np_rng.permutation(n)
            batches = idx[: (n // bs) * bs].reshape(-1, bs)
        # an epoch has its loader's natural length (the reference's
        # drop_last DataLoader)
        if not len(batches):
            raise ValueError(f"epoch {epoch} ({mode}) has no full batch of {bs} "
                             f"from {n} training frames")
        if self.semi:
            unlab = n + np_rng.integers(0, len(self.unlabeled_set),
                                        size=(len(batches), self.batch_size - bs))
            batches = np.concatenate([batches, unlab], axis=1)
        return batches

    def _count_inds(self, epoch: int, batches: np.ndarray) -> None:
        """Keep `epoch`'s batches and count how often each labelled sample
        is drawn (the reference's ind_dist, EncDec_Manager.py:70-77)."""
        self.epoch_batches[epoch] = batches
        flat = batches.reshape(-1)
        np.add.at(self.ind_counts, flat[flat < len(self.ind_counts)], 1)

    # --------------------------------------------------------------- train
    def train(self) -> dict:
        """Train from `start_epoch` to `epochs`, validating each epoch;
        returns the last validation's metrics."""
        cfg = self.config
        print(f"[{self.run_id}] training {cfg.get('graph', {}).get('model')} "
              f"task {self.task}: {self.num_params / 1e6:.1f}M params, "
              f"{self.steps_per_epoch} steps/epoch x {self.epochs} epochs on "
              f"{self.device}")
        ckpt.write_info_json(self.run_dir, cfg, self.metrics)
        np_rng = np.random.default_rng(self.seed)
        # resume: the index streams are functions of the seeds alone, so
        # replaying the epochs already trained leaves np_rng, the samplers'
        # generators and ind_counts where an uninterrupted run has them
        # (the adaptive sampler's IoU feedback restarts from its prior)
        for epoch in range(self.start_epoch):
            self._count_inds(epoch, self._epoch_batches(epoch, np_rng))
        profile_epoch = cfg.get("profile_epoch")
        adaptive_sync = int(cfg.get("adaptive_sync_every", 8))

        for epoch in range(self.start_epoch, self.epochs):
            batches = self._epoch_batches(epoch, np_rng)
            self._count_inds(epoch, batches)
            adaptive = self.train_schedule.get(epoch) == "adaptive_batching"
            running_cm, adaptive_cm = None, None
            running_loss = torch.zeros((), device=self.device)
            timer = StepTimer()     # the epoch's steps, not the validation between
            t_epoch = time.perf_counter()
            with contextlib.ExitStack() as stack:
                if profile_epoch == epoch:
                    stack.enter_context(profile_steps(self.run_dir, self.device))
                for bi, (images, labels, _) in enumerate(epoch_iterator(
                        self._iter_set, batches, self.device, prefetch=2,
                        pipeline=self.pipeline, seed=self.seed + epoch)):
                    m = self.train_step(self.state, images, labels, epoch)
                    if self.debugging:
                        self._dump_debug_batch(m, epoch, bi)
                    cm = m["confusion_matrix"]
                    running_cm = cm if running_cm is None else running_cm + cm
                    running_loss += m["loss"]
                    timer.tick()
                    if adaptive:
                        # the IoU feedback is read back every adaptive_sync
                        # steps, not every step as the reference does
                        adaptive_cm = cm if adaptive_cm is None else adaptive_cm + cm
                        if (bi + 1) % adaptive_sync == 0 or bi + 1 == len(batches):
                            iou = mean_iou_breakdown(adaptive_cm.cpu().numpy(),
                                                     self.task)["per_class"]
                            self.adaptive_sampler.update_iou(np.asarray(iou)[
                                : len(self.adaptive_sampler.iou_values)])
                            adaptive_cm = None
                    if self.global_step % self.log_every_n_steps == 0:
                        self.train_writer.scalars(
                            {k: float(v) for k, v in m.items()
                             if v.ndim == 0}, self.global_step, prefix="metrics/")
                        self.train_writer.scalar("parameters/learning_rate",
                                                 self.schedule(self.state.step),
                                                 self.global_step)
                    self.global_step += 1
            # the epoch's metrics: one read-back of the matrix and the loss
            cm = running_cm.cpu().numpy().astype(np.int64)
            loss = float(running_loss) / len(batches)
            seconds = time.perf_counter() - t_epoch
            bd = mean_iou_breakdown(cm, self.task)
            pa, _ = pixel_accuracy(cm)
            fps = len(batches) * self.batch_size / seconds
            print(f"[{self.run_id}] epoch {epoch:03d}: loss {loss:.4f} "
                  f"miou {float(bd['miou']):.4f} pa {float(pa):.4f} "
                  f"{timer.mean_ms:.0f} ms/step {fps:.1f} fps")
            self.train_metrics = {
                "epoch": epoch, "miou": float(bd["miou"]), "pa": float(pa),
                "loss": loss, "steps": len(batches), "seconds": seconds,
                "ms_per_step": timer.mean_ms, "frames_per_s": fps}
            self.train_writer.scalar("metrics/epoch_miou", bd["miou"], epoch)
            self.train_writer.scalar("metrics/epoch_fps", fps, epoch)
            self.validate(epoch)
        ckpt.save_checkpoint(self.ckpt_dir, "last", self.model, self.epochs - 1,
                             self.best_miou, self.best_loss, self.state)
        self.train_writer.figure("ind_dist", index_histogram_figure(self.ind_counts),
                                 self.global_step)
        np.savez(self.run_dir / "ind_dist.npz", ind_counts=self.ind_counts,
                 **{f"batches_e{e:03d}": b for e, b in self.epoch_batches.items()})
        self.train_writer.flush()
        return self.metrics

    def _dump_debug_batch(self, m: dict, epoch: int, bi: int) -> None:
        """img|gt|pred triptychs of a train batch under <run_dir>/debug/ in
        debugging mode (the reference's EncDec_Manager.py:86-94, 201-206)."""
        dbg = self.run_dir / "debug"
        dbg.mkdir(exist_ok=True)
        imgs, lbls, preds = (m[k].cpu().numpy()
                             for k in ("debug_img", "debug_lbl", "debug_pred"))
        for k in range(imgs.shape[0]):
            comb = np.concatenate([imgs[k], mask_to_colormap(lbls[k], self.task),
                                   mask_to_colormap(preds[k], self.task)], axis=1)
            png.write_png(dbg / f"e{epoch:03d}_b{bi:04d}_{k}.png", comb)

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
        same log_path (a published run directory), into the model, and its
        optimiser state and step where it has them (a `last` checkpoint);
        `train()` then goes on from the epoch after the checkpoint's."""
        ckpt_dir = self.ckpt_dir if run_id is None else \
            pathlib.Path(self.config.get("log_path", "logs")) / run_id / "chkpts"
        meta = ckpt.restore_checkpoint(ckpt_dir, which, self.model, self.state)
        self.start_epoch = meta["epoch"] + 1
        self.best_miou = meta["best_miou"]
        self.best_loss = meta["best_loss"]
        # the optimiser's step counts the train batches, so it is the
        # global step: the train scalars go on where the run stopped
        self.global_step = self.state.step
        return meta

    def infer(self, tta: bool | None = None) -> dict:
        """Test/validation inference over the valid set: one warm-up batch,
        then the timed loop; `frames_per_sec` counts the real records over
        the host time to the last batch's results (after a device
        synchronise), the warm-up excluded. With `tta` the step is the
        flip x multi-scale TTA step (`_make_tta_step`), whose merged
        probabilities give the matrix and the triptychs."""
        tta = bool(self.config.get("tta", False) if tta is None else tta)
        step = self._make_tta_step() if tta else self.eval_step
        n = len(self.valid_set)
        bs = self.valid_batch_size
        batches, n_pad = eval_batches(n, bs)
        max_imgs = int(self.config.get("max_valid_imgs", 10))
        log_at = set(np.round(np.linspace(0, len(batches) - 1,
                                          max_imgs)).astype(int).tolist())
        wi, wl, _ = assemble_batch(self.valid_set, batches[0])
        w_logits, _, _ = step(self.model, wi, wl)
        w_logits[0].argmax(dim=0).cpu()
        self._synchronize()
        decoded0 = dict(DECODED)
        cm_total = np.zeros((self.num_classes, self.num_classes), np.int64)
        t0 = time.perf_counter()
        for bi, (images, labels, _) in enumerate(epoch_iterator(
                self.valid_set, batches, self.device, prefetch=2)):
            if n_pad and bi == len(batches) - 1:
                labels[bs - n_pad:] = 255      # mask the repeated records
            logits, lbl, cm = step(self.model, images, labels)
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
                   "device": str(self.device), "valid_batch_size": bs,
                   "tta": tta}
        print(f"[{self.run_id}] infer: " + ", ".join(
            f"{k} {v}" for k, v in results.items() if k != "confusion_matrix"))
        ckpt.write_info_json(self.run_dir, self.config, results)
        return results

    def _make_tta_step(self):
        """The reference's ttach Compose(HFlip, Scale(tta_scales)), mean
        merge (BaseManager.py:652-660), on the eval step's preprocessing;
        a single-model recipe."""
        if self.ensemble:
            raise ValueError("TTA is a single-model recipe (BaseManager.infer); "
                             "the Ensemble merges its members instead")
        return make_tta_step(self.eval_spec, self.num_classes,
                             self.config.get("tta_scales", TTA_SCALES),
                             self.device, self.precision)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
