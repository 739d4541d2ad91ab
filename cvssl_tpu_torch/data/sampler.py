"""Batch samplers (the port's own copy of ``cvssl_tpu/data/sampler.py``:
``TwoStreamBatchSampler`` and ``ShuffleBatchSampler``; numpy only, so the
same ``Generator`` gives the same index stream).

Each batch = (batch_size - secondary_batch_size) primary (labeled) indices +
secondary_batch_size secondary (unlabeled) indices; one epoch is one pass
over the primary indices, reshuffled each epoch; the secondary stream is an
endless reshuffling (reference ``dataset.py:247-294``).

A sampler keeps its place in the stream (the epoch's permutations and the
positions in them) and makes its draws at the moments the JAX package's
generators make them: an epoch's permutation when its first batch is asked
for, a secondary permutation when the previous one runs out. So a
generator shared with the host transforms is drawn in JAX's order, and
:meth:`state_dict` (the place and the generator's state) lets a resumed
run continue the stream where it was saved.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


def _array_or_none(v):
    return None if v is None else np.asarray(v, np.int64)


def _list_or_none(v):
    return None if v is None else [int(i) for i in v]


class _Stream:
    """One epoch (``iter``) or the endless stream (``epochs``) of a
    sampler's ``_next`` batches."""

    def __iter__(self) -> Iterator[List[int]]:
        self._reset()
        for _ in range(len(self)):
            yield self._next()

    def epochs(self, state: Optional[dict] = None) -> Iterator[List[int]]:
        """Endless stream of batches, epoch after epoch; from ``state``
        (:meth:`state_dict`) it continues a saved stream."""
        if state is None:
            self._reset()
        else:
            self.load_state_dict(state)
        while True:
            yield self._next()


class TwoStreamBatchSampler(_Stream):
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
        self._reset()

    def __len__(self):
        return len(self.primary_indices) // self.primary_batch_size

    def _reset(self):
        self._primary = self._secondary = None
        self._p_pos = self._s_pos = 0

    def _next(self) -> List[int]:
        pb = self.primary_batch_size
        if self._primary is None or self._p_pos + pb > len(self._primary):
            # a new epoch: its permutation, and a new secondary stream
            self._primary = self.rng.permutation(self.primary_indices)
            self._p_pos = 0
            self._secondary = None
        batch = list(self._primary[self._p_pos:self._p_pos + pb])
        self._p_pos += pb
        for _ in range(self.secondary_batch_size):
            if self._secondary is None or \
                    self._s_pos == len(self._secondary):
                self._secondary = self.rng.permutation(
                    self.secondary_indices)
                self._s_pos = 0
            batch.append(self._secondary[self._s_pos])
            self._s_pos += 1
        return batch

    def state_dict(self) -> dict:
        """The stream's place and the generator's state (Python ints and
        lists, which ``torch.load(weights_only=True)`` reads)."""
        return {"rng": self.rng.bit_generator.state,
                "primary": _list_or_none(self._primary),
                "p_pos": self._p_pos,
                "secondary": _list_or_none(self._secondary),
                "s_pos": self._s_pos}

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._primary = _array_or_none(state["primary"])
        self._secondary = _array_or_none(state["secondary"])
        self._p_pos, self._s_pos = int(state["p_pos"]), int(state["s_pos"])


class ShuffleBatchSampler(_Stream):
    """Plain shuffling batch sampler (supervised baseline; DataLoader
    shuffle=True equivalent, drop_last). JAX: ``sampler.ShuffleBatchSampler``.
    """

    def __init__(self, num_samples: int, batch_size: int, rng=None):
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.rng = rng or np.random.default_rng()
        self._reset()

    def __len__(self):
        return self.num_samples // self.batch_size

    def _reset(self):
        self._perm, self._pos = None, 0

    def _next(self) -> List[int]:
        if self._perm is None or self._pos + self.batch_size > \
                self.num_samples:
            self._perm = self.rng.permutation(self.num_samples)
            self._pos = 0
        batch = list(self._perm[self._pos:self._pos + self.batch_size])
        self._pos += self.batch_size
        return batch

    def state_dict(self) -> dict:
        return {"rng": self.rng.bit_generator.state,
                "perm": _list_or_none(self._perm), "pos": self._pos}

    def load_state_dict(self, state: dict) -> None:
        self.rng.bit_generator.state = state["rng"]
        self._perm = _array_or_none(state["perm"])
        self._pos = int(state["pos"])
