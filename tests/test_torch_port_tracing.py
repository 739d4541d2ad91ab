"""The port's spans and step phases (``utils/tracing.py``) on the CPU: a
span is a host operation of a ``torch.profiler`` trace and not a user
annotation; an eager step records its phases (host time here), the
teacher's inside the forward's, their sum inside the step's wall time; a
graph's marks and the eager set are told apart as a capture and a replay
make them (with a stand-in for the card's events); the sliding window's
hand-over spans; and the test CLIs' ``times`` filled from spans."""
import math
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cvssl_tpu_torch.data.device_store import DeviceSliceStore
from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler
from cvssl_tpu_torch.eval import test_2d, val3d
from cvssl_tpu_torch.models import net_factory
from cvssl_tpu_torch.train.config import TrainConfig
from cvssl_tpu_torch.train.engine import Engine
from cvssl_tpu_torch.train.methods.base import get_method
from cvssl_tpu_torch.utils import tracing


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_registry(monkeypatch):
    monkeypatch.setattr(tracing, "_REGISTRY", tracing._Registry())


B, LB, HW, C = 4, 2, 32, 4
FEATURES = (4, 8, 16, 32, 64)
PHASES = ("gather", "forward", "backward", "update")


def _traced(fn):
    """The host events of ``fn()`` under the profiler (CPU activity)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


@pytest.mark.parametrize("make", [
    lambda: tracing.span("val3d.forward"),
    lambda: tracing.span("val3d.forward", {}),
    lambda: tracing.phase("val3d.forward"),
], ids=["span", "timed_span", "phase_outside_a_step"])
def test_a_span_is_a_host_operation_not_a_user_annotation(make):
    def work():
        with make():
            torch.ones(8).sum()
    events = [e for e in _traced(work) if e.name == "val3d.forward"]
    assert len(events) == 1
    ev = events[0]
    assert not ev.is_user_annotation
    assert ev.device_type == torch.autograd.DeviceType.CPU
    assert ev.time_range.end > ev.time_range.start


def test_a_timed_span_adds_under_the_last_part_of_its_name():
    times = {"zoom_in": 1.0}
    for _ in range(2):
        with tracing.span("test_2d.zoom_in", times):
            time.sleep(0.002)
    assert times["zoom_in"] >= 1.004 and set(times) == {"zoom_in"}


# ---------------------------------------------------------------------------
# the step's phases
# ---------------------------------------------------------------------------

class _Slices:
    def __len__(self):
        return 12

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, (40, HW)).astype(np.float32),
                "label": r.integers(0, C, (40, HW)).astype(np.uint8)}


def _engine(method):
    cfg = TrainConfig(method=method, model="unet", num_classes=C,
                      batch_size=B, labeled_bs=LB, patch_size=(HW, HW),
                      labeled_slices_override=LB, dtype="float32",
                      s2d_levels=0, num_devices=1)

    class Narrow(type(get_method(method, cfg))):
        def _factory(self, net_type):
            kw = self.cfg.model_kwargs(net_type)
            kw["features"] = FEATURES
            return net_factory(net_type, 1, C, **kw)
    engine = Engine(cfg, method=Narrow(cfg), device="cpu")
    engine.attach_store(DeviceSliceStore(_Slices(), (HW, HW), device="cpu"))
    state = engine.init_state()
    state.step = 1500
    rows = TwoStreamBatchSampler(range(4), range(4, 12), B, B - LB,
                                 rng=np.random.default_rng(0)).epochs()
    return engine, state, rows


@pytest.mark.parametrize("method,teacher", [
    ("mean_teacher", True), ("uamt", True), ("supervised", False)])
def test_an_eager_step_records_its_phases(method, teacher):
    engine, state, rows = _engine(method)
    assert tracing.step_ms() == {}
    t0 = time.perf_counter()
    engine.train_step_indices(state, next(rows))
    wall = (time.perf_counter() - t0) * 1e3
    ms = tracing.step_ms()
    assert set(ms) == set(PHASES) | ({"teacher"} if teacher else set())
    assert all(v >= 0 for v in ms.values())
    assert sum(ms[p] for p in PHASES) <= wall
    if teacher:
        assert 0 < ms["teacher"] <= ms["forward"]
    # the newest step replaces the last; a phase outside a step times
    # nothing
    with tracing.phase("teacher"):
        pass
    engine.train_steps(state, [next(rows)])
    assert set(tracing.step_ms()) == set(ms)


def test_uamt_adds_up_its_teacher_calls(monkeypatch):
    """2D UAMT on a BatchNorm teacher makes two teacher calls (the target
    pass and the scan of T / 2 passes): both count in ``teacher``."""
    engine, state, rows = _engine("uamt")
    calls = []
    real = tracing.phase
    monkeypatch.setattr(tracing, "phase",
                        lambda name: calls.append(name) or real(name))
    engine.train_step_indices(state, next(rows))
    assert calls.count("teacher") == 2
    assert calls.count("forward") == 1 and calls.count("gather") == 1


class _FakeEvent:
    """A stand-in for ``torch.cuda.Event``: ``record`` reads the host
    clock."""

    made = []

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing
        self.external, self.t = external, None
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_card_marks_pair_events_by_phase_and_captures_keep_their_own(
        monkeypatch):
    """On a card (events faked): eager steps reuse one set of events,
    repeated and nested phases add up by name, a step recorded while the
    stream is captured gets ``external`` events of its own and leaves the
    newest step alone until its graph is replayed."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    _FakeEvent.made = []
    card = torch.device("cuda", 0)

    def a_step():
        with tracing.step(card):
            with tracing.phase("forward"):
                for _ in range(2):
                    with tracing.phase("teacher"):
                        time.sleep(0.001)
            with tracing.phase("update"):
                pass
    a_step()
    first = tracing.step_ms()
    assert set(first) == {"forward", "teacher", "update"}
    assert 2.0 <= first["teacher"] <= first["forward"]
    eager = len(_FakeEvent.made)
    assert eager == 8 and not any(e.external for e in _FakeEvent.made)
    a_step()
    assert len(_FakeEvent.made) == eager      # reused

    capturing[0] = True
    a_step()
    capturing[0] = False
    marks = tracing.take_captured()
    assert tracing.take_captured() is None
    assert len(_FakeEvent.made) == 2 * eager
    assert all(e.external for e in _FakeEvent.made[eager:])
    assert tracing._REGISTRY.newest is not marks
    tracing.replayed(marks)
    assert tracing._REGISTRY.newest is marks
    tracing.replayed(None)
    assert tracing._REGISTRY.newest is marks
    assert set(tracing.step_ms()) == set(first)


# ---------------------------------------------------------------------------
# the sliding window's spans, the test CLIs' times
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("patch_batch", [4, 6])
def test_the_hand_over_of_a_volume_is_spanned(patch_batch):
    patch, shape = (16, 16, 16), (20, 24, 22)
    ev = val3d.SlidingWindowEvaluator(
        lambda x: torch.softmax(torch.cat([x, -x], 1), 1), patch, 2, 8, 8,
        patch_batch=patch_batch, device="cpu")
    windows = len(ev.plan(shape)[2])
    rng = np.random.default_rng(0)
    vols = [rng.normal(size=shape).astype(np.float32) for _ in range(2)]
    events = _traced(lambda: [ev.predict_volume_async(v)() for v in vols])
    names = [e.name for e in events]
    batches = math.ceil(windows / patch_batch)
    assert names.count("val3d.predict") == 2
    assert names.count("val3d.forward") == 2 * batches
    assert names.count("val3d.accumulate") == 2 * 2 * batches
    predict = [e.time_range for e in events if e.name == "val3d.predict"]
    for e in events:
        if e.name in ("val3d.forward", "val3d.accumulate"):
            assert any(r.start <= e.time_range.start and
                       e.time_range.end <= r.end for r in predict)


def test_test_2d_times_come_from_spans(tmp_path):
    flags = types.SimpleNamespace(patch_size=(16, 16), num_classes=2,
                                  full_metrics=True)
    rng = np.random.default_rng(0)
    image = rng.normal(size=(3, 20, 24)).astype(np.float32)
    label = (image > 0).astype(np.uint8)

    def predict(x):
        return (x[:, 0] > 0).to(torch.uint8)
    times = {}
    events = _traced(lambda: test_2d.test_single_volume(
        image, label, predict, flags, "case", str(tmp_path), times))
    assert set(times) == set(test_2d.PHASES)
    assert all(v > 0 for v in times.values())
    names = {e.name for e in events}
    assert {f"test_2d.{p}" for p in test_2d.PHASES} <= names
