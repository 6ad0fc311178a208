"""Index samplers (counterpart of
``detectron2_tpu/data/samplers/distributed_sampler.py``): ``TrainingSampler``
:34, ``RandomSubsetTrainingSampler`` :63, ``RepeatFactorTrainingSampler``
:87 with ``repeat_factors_from_category_frequency`` :103, and
``InferenceSampler``. The port runs one process until the distributed slice
(ROADMAP A6): a world of one process, rank 0. A sampler given no seed draws
one from numpy's global state, as the JAX package's ``shared_random_seed``
does; the train loader passes seeds drawn from its own ``RandomState``."""

import itertools
import logging
import math
from collections import defaultdict
from typing import Iterator, List, Optional

import numpy as np

__all__ = ["InferenceSampler", "RandomSubsetTrainingSampler", "RepeatFactorTrainingSampler", "TrainingSampler"]

logger = logging.getLogger(__name__)

_RANK, _WORLD_SIZE = 0, 1


def _seed(seed: Optional[int]) -> int:
    return int(np.random.randint(2**31)) if seed is None else int(seed)


class TrainingSampler:
    """An infinite stream of indices ``0 .. size - 1``: a fresh permutation
    of them per epoch (or in order, with ``shuffle=False``), drawn from
    ``RandomState(seed)``."""

    def __init__(self, size: int, shuffle: bool = True, seed: Optional[int] = None):
        if not isinstance(size, int):
            raise TypeError(f"TrainingSampler(size=) expects an int. Got type {type(size)}.")
        if size <= 0:
            raise ValueError(f"TrainingSampler(size=) expects a positive int. Got {size}.")
        self._size = size
        self._shuffle = shuffle
        self._seed = _seed(seed)

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(self._infinite_indices(), _RANK, None, _WORLD_SIZE)

    def _infinite_indices(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size).tolist()
            else:
                yield from range(self._size)


class RandomSubsetTrainingSampler(TrainingSampler):
    """:class:`TrainingSampler` over a fixed random subset of
    ``subset_ratio`` of the indices."""

    def __init__(self, size: int, subset_ratio: float, shuffle: bool = True, seed_shuffle=None, seed_subset=None):
        super().__init__(size=size, shuffle=shuffle, seed=seed_shuffle)
        assert 0.0 < subset_ratio <= 1.0
        self._size_subset = int(size * subset_ratio)
        assert self._size_subset > 0
        rng = np.random.RandomState(_seed(seed_subset))
        self._indexes_subset = np.sort(rng.permutation(size)[: self._size_subset])
        logger.info("Using RandomSubsetTrainingSampler......")

    def _infinite_indices(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            if self._shuffle:
                yield from self._indexes_subset[rng.permutation(self._size_subset)].tolist()
            else:
                yield from self._indexes_subset.tolist()


class RepeatFactorTrainingSampler:
    """Each epoch repeats image i ``floor(r_i)`` times, plus once more with
    probability ``r_i - floor(r_i)`` (LVIS class balancing)."""

    def __init__(self, repeat_factors: np.ndarray, *, shuffle: bool = True, seed: Optional[int] = None):
        self._shuffle = shuffle
        self._seed = _seed(seed)
        self._int_part = np.trunc(repeat_factors)
        self._frac_part = repeat_factors - self._int_part

    @staticmethod
    def repeat_factors_from_category_frequency(dataset_dicts, repeat_thresh: float, sqrt: bool = True) -> np.ndarray:
        """Per image, the largest ``r(c) = max(1, f(t / freq(c)))`` of its
        categories, ``f`` the square root or the identity."""
        category_freq: dict = defaultdict(int)
        for dataset_dict in dataset_dicts:
            for cat_id in {ann["category_id"] for ann in dataset_dict["annotations"]}:
                category_freq[cat_id] += 1
        num_images = len(dataset_dicts)
        for k, v in category_freq.items():
            category_freq[k] = v / num_images

        def f(x):
            return math.sqrt(x) if sqrt else x

        category_rep = {cat_id: max(1.0, f(repeat_thresh / freq)) for cat_id, freq in category_freq.items()}
        rep_factors = [
            max({category_rep[c] for c in {ann["category_id"] for ann in d["annotations"]}}, default=1.0)
            for d in dataset_dicts
        ]
        return np.asarray(rep_factors, dtype=np.float32)

    def _get_epoch_indices(self, rng: np.random.RandomState) -> np.ndarray:
        rands = rng.rand(len(self._frac_part))
        rep_factors = self._int_part + (rands < self._frac_part).astype(np.float64)
        indices = []
        for dataset_index, rep_factor in enumerate(rep_factors):
            indices.extend([dataset_index] * int(rep_factor))
        return np.asarray(indices, dtype=np.int64)

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(self._infinite_indices(), _RANK, None, _WORLD_SIZE)

    def _infinite_indices(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            indices = self._get_epoch_indices(rng)
            if self._shuffle:
                yield from indices[rng.permutation(len(indices))].tolist()
            else:
                yield from indices.tolist()


class InferenceSampler:
    """Exact partition of the indices ``0 .. size - 1`` across processes, in
    order: every index is produced once, by one process."""

    def __init__(self, size: int):
        assert size > 0
        self._size = size
        self._local_indices = self._get_local_indices(size, _WORLD_SIZE, _RANK)

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
