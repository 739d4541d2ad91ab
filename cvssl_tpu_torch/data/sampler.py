"""Batch samplers (the port's own copy of ``cvssl_tpu/data/sampler.py``:
``TwoStreamBatchSampler`` and ``ShuffleBatchSampler``; numpy only, so the
same ``Generator`` gives the same index stream).

Each batch = (batch_size - secondary_batch_size) primary (labeled) indices +
secondary_batch_size secondary (unlabeled) indices; one epoch is one pass
over the primary indices, reshuffled each epoch; the secondary stream is an
endless reshuffling (reference ``dataset.py:247-294``).
"""
from __future__ import annotations

import itertools
from typing import Iterator, List, Sequence

import numpy as np


class TwoStreamBatchSampler:
    def __init__(self, primary_indices: Sequence[int],
                 secondary_indices: Sequence[int], batch_size: int,
                 secondary_batch_size: int, rng=None):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.secondary_batch_size = secondary_batch_size
        self.primary_batch_size = batch_size - secondary_batch_size
        self.rng = rng or np.random.default_rng()
        if not len(self.primary_indices) >= self.primary_batch_size > 0:
            raise ValueError("need 0 < primary batch <= primary indices")
        if not len(self.secondary_indices) >= self.secondary_batch_size > 0:
            raise ValueError("need 0 < secondary batch <= secondary indices")

    def __iter__(self) -> Iterator[List[int]]:
        primary_iter = iter(self.rng.permutation(self.primary_indices))
        secondary_iter = self._iterate_eternally()
        return ([*p_batch, *s_batch] for p_batch, s_batch in zip(
            _grouper(primary_iter, self.primary_batch_size),
            _grouper(secondary_iter, self.secondary_batch_size)))

    def _iterate_eternally(self):
        def shuffles():
            while True:
                yield self.rng.permutation(self.secondary_indices)
        return itertools.chain.from_iterable(shuffles())

    def __len__(self):
        return len(self.primary_indices) // self.primary_batch_size

    def epochs(self) -> Iterator[List[int]]:
        """Endless stream of batches, epoch after epoch."""
        while True:
            yield from iter(self)


class ShuffleBatchSampler:
    """Plain shuffling batch sampler (supervised baseline; DataLoader
    shuffle=True equivalent, drop_last). JAX: ``sampler.ShuffleBatchSampler``.
    """

    def __init__(self, num_samples: int, batch_size: int, rng=None):
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.rng = rng or np.random.default_rng()

    def __iter__(self) -> Iterator[List[int]]:
        perm = self.rng.permutation(self.num_samples)
        for i in range(0, self.num_samples - self.batch_size + 1,
                       self.batch_size):
            yield list(perm[i:i + self.batch_size])

    def __len__(self):
        return self.num_samples // self.batch_size

    def epochs(self) -> Iterator[List[int]]:
        while True:
            yield from iter(self)


def _grouper(iterable, n):
    args = [iter(iterable)] * n
    return zip(*args)
