"""Host -> device input pipeline (port of ``cvssl_tpu/data/pipeline.py``).

Batches are loaded one sample after another in one background prefetch
thread and collated to NCHW numpy batches; the prefetch overlaps the host
transforms with the card's step. Loading is sequential on purpose, as in
JAX: the sampler and the transforms share one ``np.random.Generator``, and
with one thread it is drawn in JAX's order (an epoch's permutation, then
each sample's transform), so the same seed gives JAX's batches.

The prefetch thread runs ahead of the step, so the generator's live state
is not the state after the batches the step has taken. ``stream()``
therefore hands each batch over with the sampler's state right after it
was loaded (:attr:`DataPipeline.consumed_state`): a checkpoint saves that,
and ``stream(state)`` continues from it, so a resumed run sees the batches
the uninterrupted run would have.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

_IMAGE_KEYS = ("image", "image_weak", "image_strong")


def collate(samples: list) -> dict:
    """Stack sample dicts into a batch dict: image-like keys gain a channel
    axis at 1 (NCHW), labels become int32. JAX: ``pipeline.collate``
    (NHWC)."""
    batch = {}
    for key in samples[0]:
        if key == "case":
            continue
        vals = [s[key] for s in samples]
        if key in _IMAGE_KEYS:
            batch[key] = np.stack(vals).astype(np.float32)[:, None]
        elif key == "onehot_label":
            batch[key] = np.stack(vals).astype(np.float32)
        elif key == "idx":
            batch[key] = np.asarray(vals, np.int32)
        else:
            batch[key] = np.stack(vals).astype(np.int32)
    return batch


def pinned(batch: dict) -> dict:
    """A numpy batch as tensors in pinned host memory, so that a
    ``non_blocking`` copy to the card does not wait for it."""
    return {k: torch.from_numpy(v).pin_memory() for k, v in batch.items()}


class DataPipeline:
    """Batches from (dataset, batch_sampler); ``stream()`` adds background
    prefetch. ``num_workers`` is kept for the JAX signature: loading is
    sequential (see the module docstring). With ``pin_memory`` the stream's
    batches are tensors in pinned host memory (pinned in the prefetch
    thread), else numpy arrays."""

    def __init__(self, dataset, batch_sampler, num_workers: int = 8,
                 prefetch: int = 4, pin_memory: bool = False):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)  # unused; see docstring
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.consumed_state: Optional[dict] = None

    def _load_batch(self, indices) -> dict:
        return collate([self.dataset[i] for i in indices])

    def __iter__(self) -> Iterator[dict]:
        """One epoch of batches (no prefetch; use ``stream`` for
        training)."""
        for indices in self.batch_sampler:
            yield self._load_batch(indices)

    def stream(self, state: Optional[dict] = None) -> Iterator[dict]:
        """Endless prefetched batch stream over the sampler's epochs, from
        the start or from ``state`` (a ``consumed_state``). Each batch
        handed over sets ``consumed_state``. An error in the prefetch
        thread is raised here."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        sampler = self.batch_sampler

        def producer():
            try:
                for indices in sampler.epochs(state):
                    if stop.is_set():
                        return
                    batch = self._load_batch(indices)
                    if self.pin_memory:
                        batch = pinned(batch)
                    q.put((batch, sampler.state_dict(), None))
            except BaseException as e:  # handed to the consumer
                q.put((None, None, e))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                batch, after, err = q.get()
                if err is not None:
                    raise err
                self.consumed_state = after
                yield batch
        finally:
            stop.set()
            # drain, so that a producer blocked in put() sees the stop
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
