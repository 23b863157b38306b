"""Host data path of the port (numpy and the standard library): the frame
table and its splits, the PNG codec, the native batch decoder, the video
reader and writer, datasets (frames, videos, submission images),
the samplers, the transform pipeline and the batch pipeline with
prefetch."""
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataframe import (  # noqa: F401
    FrameTable, canonical_count_matrix, load_frame_table, split_dataframes,
    task_count_matrix)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.dataset import (  # noqa: F401
    DECODED, ArrayDataset, ColorizationDataset, SegDataset, SubmissionDataset,
    VideoDataset, probed_frame_count, reset_decoded)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.pipeline import (  # noqa: F401
    Prefetcher, assemble_batch, epoch_iterator, eval_batches, pad_or_trim_batches)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.samplers import (  # noqa: F401
    AdaptiveBatchSampler, RepeatFactorSampler, class_repeat_factors,
    image_repeat_factors, oversample_indices, weighted_random_epoch,
    weighted_random_weights)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.transforms import (  # noqa: F401
    DeviceAugmentSpec, TransformPipeline, build_transform_pipeline, device_spec)
from miccai2021_cataract_semantic_segmentation_tpu_torch.data.video_io import (  # noqa: F401
    READERS, WRITERS, AviReader, AviWriter, open_reader, open_writer)
