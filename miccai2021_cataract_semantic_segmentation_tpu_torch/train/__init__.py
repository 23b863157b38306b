"""Eval steps, batched validation and the flax -> torch weight bridge."""
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.steps import (  # noqa: F401
    EvalSpec, eval_preprocess, eval_spec, make_eval_loss_step, make_eval_step)
from miccai2021_cataract_semantic_segmentation_tpu_torch.train.validate import (  # noqa: F401
    load_config, validate)
