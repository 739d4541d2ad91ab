"""The readers of the program's spans and step phases
(``benchmark/spans.py``, ten files under ``metrics/``): on a stub of the
program's registry and on a synthetic trace, None where the program lacks
the module, the phase or the span (as the commits before them do), and
through the harness in a traced CPU run of each cell at its small size."""
import sys
import types

import pytest

from benchmark import spec, trace

PHASES = {"step_gather_ms": "gather", "teacher_ms": "teacher",
          "backward_ms": "backward", "update_ms": "update"}
TRAIN = {f"{m}.{cell}": phase for m, phase in PHASES.items()
         for cell in ("train", "uamt3d")}
WINDOW = {"forward_host_ms.infer": "val3d.forward",
          "accumulate_host_ms.infer": "val3d.accumulate"}
CELLS = {"train": "acdc2d-mt-graphed", "uamt3d": "brats3d-uamt-graphed",
         "infer": "brats3d-window"}
LAYERS = {"step_gather_ms": "Data", "teacher_ms": "Method",
          "backward_ms": "Step loop", "update_ms": "Step loop",
          "forward_host_ms": "Validation 3D",
          "accumulate_host_ms": "Validation 3D"}
STEP = {"gather": 0.4, "forward": 30.0, "teacher": 6.5, "backward": 9.0,
        "update": 0.7}


def _trace():
    # a window of 100 us with two volumes' hand-overs: forward spans of
    # 20 + 10 and 15 us, accumulate spans of 2 + 3 and 4 us; one forward
    # span starts before the window and one ends after it
    host = [(-5.0, 3.0, "val3d.forward"),
            (5.0, 45.0, "val3d.predict"), (6.0, 8.0, "val3d.accumulate"),
            (8.0, 28.0, "val3d.forward"), (28.0, 31.0, "val3d.accumulate"),
            (31.0, 41.0, "val3d.forward"),
            (50.0, 80.0, "val3d.predict"), (51.0, 55.0, "val3d.accumulate"),
            (55.0, 70.0, "val3d.forward"), (95.0, 105.0, "val3d.forward")]
    return trace.Trace([(10.0, 60.0, "conv")], host, (0.0, 100.0))


def _run(tr=None, units=0):
    return types.SimpleNamespace(trace=tr, traced_units=units)


@pytest.fixture
def registry(monkeypatch):
    """A stand-in for ``cvssl_tpu_torch.utils.tracing`` whose newest step
    is ``STEP``."""
    stub = types.ModuleType("tracing")
    stub.step_ms = lambda: dict(STEP)
    monkeypatch.setitem(sys.modules, "cvssl_tpu_torch.utils.tracing", stub)
    return stub


@pytest.mark.parametrize("metric", sorted(TRAIN))
def test_a_phase_reader_gives_the_newest_steps_phase(metric, registry):
    read = spec.reader(metric).read
    assert read(_run(_trace(), 20)) == STEP[TRAIN[metric]]
    assert read(_run()) is None                 # no traced window
    registry.step_ms = lambda: {}               # no step, or no such phase
    assert read(_run(_trace(), 20)) is None


@pytest.mark.parametrize("metric", sorted(TRAIN))
def test_a_phase_reader_is_none_without_the_module(metric, monkeypatch):
    monkeypatch.setitem(sys.modules, "cvssl_tpu_torch.utils.tracing", None)
    assert spec.reader(metric).read(_run(_trace(), 20)) is None


@pytest.mark.parametrize("metric,want", [
    ("forward_host_ms.infer", (20 + 10 + 15) * 1e-3 / 2),
    ("accumulate_host_ms.infer", (2 + 3 + 4) * 1e-3 / 2)])
def test_a_span_reader_sums_the_windows_spans_by_volume(metric, want):
    read = spec.reader(metric).read
    assert read(_run(_trace(), 2)) == pytest.approx(want)
    assert read(_run()) is None
    assert read(_run(_trace(), 0)) is None
    bare = trace.Trace([(10.0, 60.0, "conv")],
                       [(5.0, 45.0, "bench.enqueue")], (0.0, 100.0))
    assert read(_run(bare, 2)) is None          # a program without spans


@pytest.mark.parametrize("metric", sorted(TRAIN) + sorted(WINDOW))
def test_each_reader_is_an_entry_of_its_one_cell(metric):
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[metric]
    base, cell = metric.rsplit(".", 1)
    assert entry["workloads"] == [CELLS[cell]]
    assert entry["source"] == "program_span" and entry["unit"] == "ms"
    assert entry["better"] == "lower" and entry["layer"] == LAYERS[base]
    assert metric in {m["name"] for m in spec.cell(CELLS[cell])["per_layer"]}


@pytest.mark.parametrize("name", sorted(CELLS.values()))
def test_a_traced_small_run_reports_the_programs_spans(name):
    """Through the harness on the CPU, where the program's phases read
    the host clock and the device's metrics find nothing."""
    from benchmark import harness
    from conftest import SMALL
    result, _, _ = harness.execute(name, 4200000011, 0.3, True,
                                   device="cpu", overrides=SMALL[name],
                                   log=lambda m: None)
    assert result["correct"]
    want = {m for m in list(TRAIN) + list(WINDOW)
            if CELLS[m.rsplit(".", 1)[1]] == name}
    assert len(want) in (2, 4) and want <= set(result["metrics"])
    assert all(result["metrics"][m]["value"] > 0 for m in want)
