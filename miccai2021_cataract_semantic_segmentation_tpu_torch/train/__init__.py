"""Train and eval steps, the train state, LR schedules, `train_steps`,
batched validation, the config system, checkpoints, loggers, the
Trainer, TTA, video inference, the serving export and the flax -> torch
weight bridge."""
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.lr_schedule import (  # noqa: F401
    build_multiplier_table, make_schedule)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.state import (  # noqa: F401
    TrainState, create_train_state, make_optimizer)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (  # noqa: F401
    TTA_SCALES, EvalSpec, eval_preprocess, eval_spec, make_eval_loss_step,
    make_eval_step, make_train_step, make_tta_step, tta_merged_probs)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.train import train_steps  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.config import (  # noqa: F401
    DEFAULT_CONFIG_FLAT, DEFAULT_CONFIG_NESTED, apply_cli_overrides, load_config,
    parse_config, with_encdec_graph)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import validate  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.trainer import Trainer  # noqa: F401
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.video import (  # noqa: F401
    demo_infer, discover_videos)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.export import (  # noqa: F401
    export_fn, export_serving, export_trainer, load_serving, make_ensemble_serving_fn,
    make_serving_fn, save_serving, write_sidecar)
