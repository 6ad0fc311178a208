"""The inference sampler (``InferenceSampler`` of
``detectron2_tpu/data/samplers/distributed_sampler.py``). The port runs one
process until the distributed slice (ROADMAP A6): a world of one process,
rank 0."""

from typing import Iterator, List

__all__ = ["InferenceSampler"]


class InferenceSampler:
    """Exact partition of the indices ``0 .. size - 1`` across processes, in
    order: every index is produced once, by one process."""

    def __init__(self, size: int):
        assert size > 0
        self._size = size
        self._rank, self._world_size = 0, 1
        self._local_indices = self._get_local_indices(size, self._world_size, self._rank)

    @staticmethod
    def _get_local_indices(total_size: int, world_size: int, rank: int) -> List[int]:
        shard_size = total_size // world_size
        left = total_size % world_size
        shard_sizes = [shard_size + int(r < left) for r in range(world_size)]
        begin = sum(shard_sizes[:rank])
        end = min(sum(shard_sizes[: rank + 1]), total_size)
        return list(range(begin, end))

    def __iter__(self) -> Iterator[int]:
        yield from self._local_indices

    def __len__(self) -> int:
        return len(self._local_indices)
