"""BENCHMARK.json keeps to the contract, and the harness finds a cell, a
configuration, a traffic mix and a metric that are added as files alone."""
import json
import re
import shutil

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    text = entry[key]
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (entry["name"], key)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
    assert len(set(names)) == len(names)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (spec.CHECKOUT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_every_cell_reports_enough():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"])
        e2e = {m["name"] for m in cell["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell["per_layer"]
        for m in cell["per_layer"]:
            assert m["moves"] in e2e
            assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        for m in cell["end_to_end"]:
            assert (spec.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert cell["limits"]["limits"]


def test_per_layer_moves_are_reported_where_listed():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in target.get("workloads", [cell])


def test_the_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_harness_finds_added_files(tmp_path, monkeypatch, small):
    """A cell, a configuration, a mix and a metric added as files alone."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    here = root / "benchmark"
    cfg = json.loads((here / "configs" / "unet2d-acdc.json").read_text())
    cfg["name"] = "unet2d-acdc-k"
    (here / "configs" / "unet2d-acdc-k.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "train-scan-2d.json").read_text())
    mix["scan_steps"] = 5
    (here / "traffic" / "train-scan-2d-k5.json").write_text(json.dumps(mix))
    (here / "workloads" / "acdc2d-k5.json").write_text(
        (here / "workloads" / "acdc2d-mt-graphed.json").read_text())
    (here / "metrics" / "steps_per_s.k5.py").write_text(
        "def read(run):\n"
        "    w = run.window\n"
        "    return None if w is None else w['steps'] / w['seconds']\n")
    bench["configs"].append({"name": "unet2d-acdc-k", "source": "x",
                             "file": "benchmark/configs/unet2d-acdc-k.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "acdc2d-k5", "config": "unet2d-acdc-k",
                               "traffic": "train-scan-2d-k5", "chips": 1,
                               "why": "a test"})
    bench["end_to_end"].append({"name": "steps_per_s.k5", "unit": "steps/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["acdc2d-k5"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(spec, "HERE", here)
    monkeypatch.setattr(spec, "CHECKOUT", root)
    cell = spec.cell("acdc2d-k5")
    assert cell["traffic"]["scan_steps"] == 5
    assert cell["config"]["name"] == "unet2d-acdc-k"
    assert {m["name"] for m in cell["end_to_end"]} == {"steps_per_s.k5",
                                                       "setup_s"}
    from benchmark import harness
    from conftest import SMALL
    overrides = {"config": SMALL["acdc2d-mt-graphed"]["config"],
                 "traffic": dict(SMALL["acdc2d-mt-graphed"]["traffic"],
                                 scan_steps=5)}
    result, _, _ = harness.execute("acdc2d-k5", 3, 0.3, False,
                                   device="cpu", overrides=overrides,
                                   log=lambda m: None)
    assert result["correct"]
    assert result["metrics"]["steps_per_s.k5"]["value"] > 0
    assert result["attempted"] % 5 == 0


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_sound_small_run_is_correct(name, small):
    result, checks = small(name)
    assert result["correct"], checks
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {m["name"] for m in
                                      spec.cell(name)["end_to_end"]}
