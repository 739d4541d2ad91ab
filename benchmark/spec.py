"""Everything the harness knows of a cell it finds by name: the cell's
entry in ``BENCHMARK.json``, its configuration file, its traffic mix
(``traffic/<mix>.json``), its correctness limits (``workloads/<cell>.json``)
and the readers of its metrics (``metrics/<metric>.py``). A cell, a mix, a
configuration or a metric is added as files alone."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell(name: str, bench: dict = None) -> dict:
    """The cell ``name``: {"name", "config" (the configuration file's
    content), "traffic" (the mix), "limits", "chips", "end_to_end" and
    "per_layer" (the metric entries it reports)}."""
    bench = bench or benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there "
                         f"are {sorted(entries)}")
    w = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(CHECKOUT / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name])
                 and m["moves"] in reported]
    return {"name": name, "config": config, "chips": w["chips"],
            "traffic": load_json(HERE / "traffic" / f"{w['traffic']}.json"),
            "limits": load_json(HERE / "workloads" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str):
    """The module ``metrics/<metric>.py``, whose ``read(run)`` gives the
    metric's value or None where the run has nothing for it."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
