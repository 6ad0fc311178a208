from detectron2_tpu_torch.data.samplers.distributed_sampler import (
    InferenceSampler,
    RandomSubsetTrainingSampler,
    RepeatFactorTrainingSampler,
    TrainingSampler,
)
from detectron2_tpu_torch.data.samplers.grouped_batch_sampler import GroupedBatchSampler

__all__ = [
    "GroupedBatchSampler",
    "InferenceSampler",
    "RandomSubsetTrainingSampler",
    "RepeatFactorTrainingSampler",
    "TrainingSampler",
]
