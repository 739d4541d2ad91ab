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

The CTAugment path (``DataPipeline(policy=...)``) has one more input: the
policies, which ``contrastive_consistency`` replaces on the main thread
(each epoch, and after an unfavorable crop). Its loader never reads the
dataset's policies. It loads a batch for each request the main thread
queues, with a copy of the policies in force when the request was made:
the first ``prefetch`` requests when the stream starts, then one each time
the main thread has run an iteration on a batch, its step and hooks
(``train/engine.py::cta_iteration``: ``on_batch``, the step,
``on_step_metrics``, at an epoch's end ``on_epoch_end`` and
``on_epoch_start``). So batch k + prefetch is loaded with the policies in
force after batch k's iteration, whatever the threads' timing, and the
loader still runs ahead of the step. The other transforms take no policy:
their stream queues each request itself as it hands a batch over.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from cvssl_tpu_torch.data.ctaugment import (np_state, policy_from_plain,
                                            policy_to_plain, set_np_state)

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
    thread), else numpy arrays.

    The loader loads one batch for each request (:meth:`request`). Without
    ``policy`` a request carries nothing, the stream makes one itself for
    each batch it hands over, and the loader reads ``dataset[i]``. With
    ``policy`` (the CTAugment path; see the module docstring), a callable
    giving the policies in force on the main thread, (ops_weak,
    ops_strong), a request carries a copy of them, the caller makes it,
    and the loader reads ``dataset.load(i, ops_weak, ops_strong)``;
    ``loader_rng`` is then the transform's own generator (cutout's,
    ``np.random.RandomState``), which only the loader draws from.

    :attr:`consumed_state` is the sampler's (and ``loader_rng``'s) state
    after the batches handed over, with the requests in flight:
    ``stream(state)`` queues those again and continues, so a resumed run
    loads the batches the uninterrupted run would have."""

    def __init__(self, dataset, batch_sampler, num_workers: int = 8,
                 prefetch: int = 4, pin_memory: bool = False,
                 policy: Optional[Callable[[], tuple]] = None,
                 loader_rng=None):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = max(1, num_workers)  # unused; see docstring
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self.policy = policy
        self.loader_rng = loader_rng
        self._consumed: Optional[dict] = None
        self._requests: Optional[queue.Queue] = None
        self._in_flight: collections.deque = collections.deque()

    @property
    def consumed_state(self) -> Optional[dict]:
        """The sampler's and the loader's states after the batches handed
        over, and the requests in flight."""
        if self._consumed is None:
            return None
        return {**self._consumed, "requests": list(self._in_flight)}

    def request(self) -> None:
        """Queue the request for the next batch not yet asked for: with a
        ``policy``, a copy of the policies in force now."""
        self._queue([] if self.policy is None else
                     [policy_to_plain(ops) for ops in self.policy()])

    def _queue(self, plain: list) -> None:
        self._in_flight.append(plain)
        self._requests.put(plain)

    def _load_batch(self, indices, plain=()) -> dict:
        if not plain:
            return collate([self.dataset[i] for i in indices])
        ops = [policy_from_plain(p) for p in plain]
        return collate([self.dataset.load(i, *ops) for i in indices])

    def __iter__(self) -> Iterator[dict]:
        """One epoch of batches (no prefetch; use ``stream`` for
        training)."""
        for indices in self.batch_sampler:
            yield self._load_batch(indices)

    def stream(self, state: Optional[dict] = None) -> Iterator[dict]:
        """Endless prefetched batch stream over the sampler's epochs, from
        the start or from ``state`` (a :attr:`consumed_state`). The first
        requests are queued now (``prefetch`` of them, or ``state``'s in
        flight): with a ``policy``, with the policies in force at this
        call. Each batch handed over sets ``consumed_state``. An error in
        the prefetch thread is raised here."""
        q: queue.Queue = queue.Queue()
        stop = threading.Event()
        requests = self._requests = queue.Queue()
        self._in_flight.clear()
        self._consumed = None
        sampler = self.batch_sampler
        if state is not None:
            if self.loader_rng is not None:
                set_np_state(self.loader_rng, state["loader"])
            for plain in state["requests"]:
                self._queue(plain)
        else:
            for _ in range(self.prefetch):
                self.request()

        def producer():
            try:
                for indices in sampler.epochs(
                        None if state is None else state["sampler"]):
                    plain = requests.get()
                    if plain is None or stop.is_set():
                        return
                    batch = self._load_batch(indices, plain)
                    if self.pin_memory:
                        batch = pinned(batch)
                    q.put((batch, {
                        "sampler": sampler.state_dict(),
                        "loader": (None if self.loader_rng is None
                                   else np_state(self.loader_rng))}, None))
            except BaseException as e:  # handed to the consumer
                q.put((None, None, e))

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()

        def batches():
            try:
                while True:
                    batch, after, err = q.get()
                    if err is not None:
                        raise err
                    self._in_flight.popleft()
                    self._consumed = after
                    if self.policy is None:
                        self.request()
                    yield batch
            finally:
                stop.set()
                requests.put(None)   # a producer waiting for one
                thread.join()
        return batches()
