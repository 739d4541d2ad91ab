"""Spans and step phases inside the port.

``span(name)`` is a host span: an operation of that name in any active
``torch.profiler`` trace, on the profiler's clock (``fit --profile_dir``,
a benchmark's traced window), nested in the host operations around it. It
is the profiler's ``_RecordFunctionFast``, a FUNCTION-scope record and not
a user annotation, so the profiler mirrors nothing of it onto the device's
timeline; it never synchronises, and with no profiler running it costs
well under a microsecond. Where torch lacks that class a span does
nothing. With ``times`` a span also adds its host seconds to
``times[key]``, ``key`` being its name after the last dot: the test CLIs'
``times`` dicts are filled so.

``phase(name)`` is a phase of a train step: the host span, and while a
step is recorded (:func:`step`, which ``Engine`` opens around each step)
the phase's time. On CUDA a phase records a pair of timing events on the
current stream; inside a CUDA graph's capture they are ``external``
events, so the pair becomes event-record nodes of the graph that every
replay records again. On the CPU, where the work is done when a call
returns, a phase reads the host clock. The entries of one phase in a step
add up (UAMT's two teacher calls in 2D); phases may nest (``teacher``
inside ``forward``). Eager steps on a card reuse one set of events; each
captured graph owns its own (:func:`take_captured`), which the engine
keeps beside the graph and points the registry at after each replay
(:func:`replayed`).

:func:`step_ms` gives {phase: ms} of the newest step that ran, eager or
replayed; it waits on that step's events alone, and only when called.

The engine's phases: ``gather`` (the device store's batch), ``forward``
(the method's loss, and the discriminator's), ``teacher`` (every EMA
teacher's pass, inside ``forward``), ``backward`` and ``update`` (the
gradients' all-reduce, the optimizers, the EMAs). The sliding window's
spans: ``val3d.predict`` (one volume's hand-over), ``val3d.forward``
(each batch of windows through the predictor) and ``val3d.accumulate``
(each batch's stacking and its adds into the score map).

The registry is the process's: one step is recorded at a time, by the
thread that runs it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:      # an older or slimmer torch: spans do nothing
    _RecordFunctionFast = None


def _host(name: str):
    if _RecordFunctionFast is None:
        return contextlib.nullcontext()
    return _RecordFunctionFast(name)


class _Timed:
    """A host span that adds its host time (seconds x ``scale``) to
    ``times[key]``."""

    __slots__ = ("_span", "_times", "_key", "_scale", "_t0")

    def __init__(self, name: str, times: Dict[str, float], key: str,
                 scale: float = 1.0):
        self._span = _host(name)
        self._times, self._key, self._scale = times, key, scale

    def __enter__(self):
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        spent = (time.perf_counter() - self._t0) * self._scale
        self._times[self._key] = self._times.get(self._key, 0.0) + spent
        return self._span.__exit__(*exc)


def span(name: str, times: Optional[Dict[str, float]] = None):
    """A host span ``name``; with ``times``, its host seconds are added to
    ``times`` under the name's part after the last dot."""
    if times is None:
        return _host(name)
    return _Timed(name, times, name.rsplit(".", 1)[-1])


class _HostMarks:
    """The phases of a step on the CPU: host milliseconds by phase."""

    captured = False

    def __init__(self):
        self._ms: Dict[str, float] = {}

    def phase(self, name: str):
        return _Timed(name, self._ms, name, 1e3)

    def ms(self) -> Dict[str, float]:
        return dict(self._ms)


class _CudaMarks:
    """The phases of a step on a card as pairs of timing events on the
    current stream: one set reused by every eager step on a device, or
    one owned by a captured graph (``external``: recorded as graph nodes,
    and again by every replay)."""

    def __init__(self, captured: bool):
        self.captured = captured
        self._pool = []          # the events, reused step after step
        self._pairs = []         # (phase, start, end) of the step

    def begin(self):
        self._pairs = []

    def phase(self, name: str):
        return _CudaPhase(self, name)

    def _pair(self, name: str):
        i = 2 * len(self._pairs)
        while len(self._pool) < i + 2:
            self._pool.append(torch.cuda.Event(enable_timing=True,
                                               external=self.captured))
        pair = (name, self._pool[i], self._pool[i + 1])
        self._pairs.append(pair)
        return pair

    def ms(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, start, end in self._pairs:
            end.synchronize()
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


class _CudaPhase:
    __slots__ = ("_marks", "_name", "_span", "_end")

    def __init__(self, marks: _CudaMarks, name: str):
        self._marks, self._name = marks, name
        self._span = _host(name)

    def __enter__(self):
        self._span.__enter__()
        _, start, self._end = self._marks._pair(self._name)
        start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        return self._span.__exit__(*exc)


class _Registry:
    def __init__(self):
        self.current = None      # the marks of the step being recorded
        self.newest = None       # the marks of the newest step that ran
        self.captured = None     # the marks of the newest step captured
        self.eager: Dict[torch.device, _CudaMarks] = {}


_REGISTRY = _Registry()


@contextlib.contextmanager
def step(device: torch.device):
    """Record the phases of the step that runs inside the block on
    ``device``; inside a recorded step it joins that step. Yields the
    step's marks. A step captured into a CUDA graph becomes the one
    :func:`take_captured` returns; any other the one :func:`step_ms`
    reads."""
    reg = _REGISTRY
    if reg.current is not None:
        yield reg.current
        return
    if device.type != "cuda":
        marks = _HostMarks()
    elif torch.cuda.is_current_stream_capturing():
        marks = _CudaMarks(captured=True)
    else:
        marks = reg.eager.get(device)
        if marks is None:
            marks = reg.eager[device] = _CudaMarks(captured=False)
        marks.begin()
    reg.current = marks
    try:
        yield marks
    finally:
        reg.current = None
    if marks.captured:
        reg.captured = marks
    else:
        reg.newest = marks


def phase(name: str):
    """The step phase ``name``: a host span, timed while a step is
    recorded."""
    marks = _REGISTRY.current
    if marks is None:
        return _host(name)
    return marks.phase(name)


def take_captured():
    """The marks of the newest step captured into a graph, once (None
    where no step was captured since the last call)."""
    marks, _REGISTRY.captured = _REGISTRY.captured, None
    return marks


def replayed(marks) -> None:
    """A graph holding ``marks`` was replayed: its step is the newest
    (``marks`` None: the newest stays)."""
    if marks is not None:
        _REGISTRY.newest = marks


def step_ms() -> Dict[str, float]:
    """{phase: ms} of the newest step that ran ({} before any): its
    events' device time on a card, waiting on those events alone; host
    time on the CPU."""
    marks = _REGISTRY.newest
    return {} if marks is None else marks.ms()
