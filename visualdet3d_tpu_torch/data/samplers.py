"""Index samplers (counterpart of ``visualdet3d_tpu/data/samplers.py``).

``TrainingSampler`` is the infinite shuffled index stream sharded by rank;
each ``__iter__`` starts the stream again from ``default_rng(seed)``, so
an epoch that iterates the loader anew replays the same permutation (as in
the JAX package). ``InferenceSampler`` is the deterministic sharded range.
"""
from __future__ import annotations

import itertools
from typing import Iterator, Optional

import numpy as np

from visualdet3d_tpu_torch.registry import SAMPLER_DICT


@SAMPLER_DICT.register_module
class TrainingSampler:
    """Infinite (shuffled) index stream, sharded rank::world_size."""

    def __init__(self, size: int, shuffle: bool = True,
                 seed: Optional[int] = None, rank: int = 0, world_size: int = 1):
        if size <= 0:
            raise ValueError(f'a sampler over {size} items')
        self.size = size
        self.shuffle = shuffle
        self.seed = 0 if seed is None else int(seed)
        self.rank = rank
        self.world_size = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(
            self._infinite_indices(), self.rank, None, self.world_size)

    def _infinite_indices(self):
        rng = np.random.default_rng(self.seed)
        while True:
            if self.shuffle:
                yield from rng.permutation(self.size).tolist()
            else:
                yield from range(self.size)


@SAMPLER_DICT.register_module
class InferenceSampler:
    """One deterministic pass, contiguous shards per rank."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        self.size = size
        shard = (size + world_size - 1) // world_size
        self.begin = min(rank * shard, size)
        self.end = min(self.begin + shard, size)

    def __iter__(self):
        return iter(range(self.begin, self.end))

    def __len__(self):
        return self.end - self.begin
