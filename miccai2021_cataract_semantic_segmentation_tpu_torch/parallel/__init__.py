"""Training and serving over several processes, one per GPU (the JAX
package's parallel/ layer): the process group and the data group
(`dist.py`), the spatial grid of data by model ranks (`spatial.py`) and a
launcher of gloo ranks for the CPU (`launch.py`)."""
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.dist import (  # noqa: F401
    DataGroup, World, broadcast_object, close, current_world, global_batch_norm,
    init_from_env, under_torchrun)
from miccai2021_cataract_semantic_segmentation_tpu_torch.parallel.spatial import (  # noqa: F401
    Grid, spatial_rows)
