"""Host data helpers of the port (numpy only)."""
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import eval_batches  # noqa: F401
