from detectron2_tpu_torch.data.samplers.distributed_sampler import InferenceSampler

__all__ = ["InferenceSampler"]
