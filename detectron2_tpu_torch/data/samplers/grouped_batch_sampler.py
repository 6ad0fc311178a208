"""Group-constrained batching (a copy of
``detectron2_tpu/data/samplers/grouped_batch_sampler.py:17``): batches whose
indices all share a group id, in the base sampler's order as far as the
groups allow."""

from typing import Iterable, Iterator, List, Sequence

import numpy as np

__all__ = ["GroupedBatchSampler"]


class GroupedBatchSampler:
    def __init__(self, sampler: Iterable[int], group_ids: Sequence[int], batch_size: int):
        """
        Args:
            sampler: base sampler producing indices in [0, N).
            group_ids: N ints, the group of each sample.
            batch_size: per-batch element count.
        """
        self.sampler = sampler
        self.group_ids = np.asarray(group_ids)
        assert self.group_ids.ndim == 1
        self.batch_size = int(batch_size)
        self._buffers = {int(k): [] for k in np.unique(self.group_ids)}

    def __iter__(self) -> Iterator[List[int]]:
        for idx in self.sampler:
            buf = self._buffers[int(self.group_ids[idx])]
            buf.append(idx)
            if len(buf) == self.batch_size:
                yield buf[:]
                del buf[:]
