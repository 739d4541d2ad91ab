"""Checkpointing with the reference's naming contract (port of
``cvssl_tpu/utils/checkpoint.py``).

Two tiers, as in the reference:
  (a) weights-only best/periodic files: ``{model}_best_model.ckpt``,
      ``iter_{k}_dice_{d}.ckpt``, ``iter_{k}.ckpt``, ``ema_model_iter_{k}.ckpt``
      (``train_fully_supervised_2D.py:163-181``), each a ``torch.save`` of a
      module's ``state_dict`` (parameters and BatchNorm buffers);
  (b) the full training state for resume, ``model_iter_{k}.ckpt``: student
      and teacher ``state_dict``s, each optimizer's ``state_dict`` with its
      update count (``ReferenceSGD.count``, which the poly LR reads), the
      step, the step generator's state, the method's extra state, and
      loop-level ``meta`` (``best_dice``).

Every file is written to ``{path}.tmp`` and renamed, so a reader never sees
a partial file.

The engine's step updates the live modules and optimizers in place, so a
checkpoint job first takes a :func:`device_snapshot` on the training
thread: every tensor cloned on the current stream, and a CUDA event recorded
after the clones. The :class:`AsyncWriter` thread's :func:`to_host` copies
the snapshot on a side stream that waits on that event, so the next steps
can be enqueued while the copy and the write run.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import queue
import re
import threading
from typing import Any, Optional

import torch


def _atomic_save(path: str, obj) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_weights(path: str, state_dict) -> None:
    _atomic_save(path, state_dict)


def load_weights(path: str):
    """A weights file or full-state file, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_train_state(snapshot_path: str, tree: dict, iteration: int,
                     meta: Optional[dict] = None) -> str:
    """Full-state checkpoint ``model_iter_{k}.ckpt`` (reference naming,
    ``utils/util.py:113-123``). ``meta`` carries loop-level values that must
    survive resume, notably per-model ``best_dice`` (the reference forgets
    it, so a resumed run could overwrite ``{model}_best_model.ckpt`` with a
    worse model)."""
    path = os.path.join(snapshot_path, f"model_iter_{iteration}.ckpt")
    _atomic_save(path, {"state": tree, "meta": meta or {}})
    return path


def _iteration(path: str) -> int:
    return int(re.search(r"model_iter_(\d+)\.ckpt$", path).group(1))


def _full_state_paths(snapshot_path: str):
    paths = glob.glob(os.path.join(snapshot_path, "model_iter_*.ckpt"))
    return sorted((p for p in paths
                   if re.search(r"model_iter_(\d+)\.ckpt$", p)),
                  key=_iteration)


def restore_latest(snapshot_path: str):
    """The newest ``model_iter_*.ckpt`` (reference ``utils/util.py:76-110``
    restore_model). Returns (state tree, iteration, meta) or (None, 0, {})."""
    paths = _full_state_paths(snapshot_path)
    if not paths:
        return None, 0, {}
    payload = load_weights(paths[-1])
    return payload["state"], _iteration(paths[-1]), payload["meta"]


def prune_old(snapshot_path: str, keep: int = 2):
    """Delete all but the ``keep`` newest full-state checkpoints."""
    for p in _full_state_paths(snapshot_path)[:-keep]:
        os.remove(p)


# ---------------------------------------------------------------------------
# the train state as a tree of tensors
# ---------------------------------------------------------------------------

def state_tree(state) -> dict:
    """Everything a bit-equal resume needs from a ``TrainState``: live
    references, so take a :func:`device_snapshot` before the next step."""
    return {
        "step": int(state.step),
        "models": {n: m.state_dict() for n, m in state.models.items()},
        "teachers": {n: m.state_dict() for n, m in state.teachers.items()},
        "optimizers": {n: {"state": o.state_dict(), "count": o.count}
                       for n, o in state.optimizers.items()},
        "generator": state.generator.get_state(),
        "extra": state.extra,
    }


def load_state_tree(state, tree: dict):
    """Restore a ``TrainState`` in place from :func:`state_tree`'s tree."""
    for n, sd in tree["models"].items():
        state.models[n].load_state_dict(sd)
    for n, sd in tree["teachers"].items():
        state.teachers[n].load_state_dict(sd)
    for n, o in tree["optimizers"].items():
        state.optimizers[n].load_state_dict(o["state"])
        state.optimizers[n].count = int(o["count"])
    state.step = int(tree["step"])
    state.generator.set_state(tree["generator"])
    state.extra = tree["extra"]
    return state


def _map_tensors(tree, fn):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, _map_tensors(v, fn)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


def _has_cuda(tree) -> bool:
    found = []
    _map_tensors(tree, lambda t: found.append(t.is_cuda))
    return any(found)


@dataclasses.dataclass
class Snapshot:
    tree: Any
    ready: Optional["torch.cuda.Event"]  # recorded after the clones


def device_snapshot(tree) -> Snapshot:
    """Clone every tensor of ``tree`` where it lies, on the current stream,
    and record an event after the clones; other leaves pass through."""
    cloned = _map_tensors(tree, lambda t: t.detach().clone())
    ready = None
    if _has_cuda(cloned):
        ready = torch.cuda.Event()
        ready.record()
    return Snapshot(cloned, ready)


def to_host(snapshot: Snapshot):
    """The snapshot's tree on the CPU. CUDA tensors are copied on a side
    stream that waits on the snapshot's event, so the copy starts as soon as
    the clones are done, whatever the training stream has queued since."""
    if snapshot.ready is None:
        return snapshot.tree
    stream = torch.cuda.Stream()
    stream.wait_event(snapshot.ready)
    with torch.cuda.stream(stream):
        host = _map_tensors(snapshot.tree, lambda t: t.to("cpu"))
    stream.synchronize()
    return host


class AsyncWriter:
    """One background worker running checkpoint jobs in submission order.

    Jobs get device snapshots (:func:`device_snapshot`) and do the copy to
    the host, serialisation and atomic write off the training thread. The
    queue holds at most 2 jobs: ``submit`` blocks when the writer falls
    behind (backpressure instead of unbounded device memory). A job's error
    is raised by the next ``submit``, ``flush`` or ``close``."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._err = None
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            job = self._q.get()
            if job is None:
                self._q.task_done()
                return
            try:
                job()
            except Exception as e:  # surfaced on the next submit/flush
                self._err = e
            finally:
                self._q.task_done()

    def _raise_stored(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, job) -> None:
        self._raise_stored()
        self._q.put(job)

    def flush(self) -> None:
        self._q.join()
        self._raise_stored()

    def close(self) -> None:
        """Drain the queue, stop the worker, and re-raise any stored job
        error: a failed final checkpoint write must not let ``fit`` return
        success."""
        self._q.put(None)
        self._q.join()
        self._t.join()
        self._raise_stored()
