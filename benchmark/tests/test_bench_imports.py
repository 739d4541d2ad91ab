"""What the benchmark loads: never JAX nor the JAX package (compared by
whole top-level names: the port's name begins with the JAX package's), and
the references nothing of the program. Without a card a run exits non-zero
and prints no result."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import spec

ROOT = spec.CHECKOUT
FORBIDDEN = {"jax", "jaxlib", "flax", "cvssl_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    for path in spec.HERE.rglob("*.py"):
        assert not set(_imports(path)) & FORBIDDEN, path


def test_references_import_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {"cvssl_tpu_torch"}), path


def test_a_run_loads_no_jax():
    """Every module a run imports, the program's among them, by whole
    top-level name."""
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import benchmark.run, benchmark.harness, benchmark.calibrate\n"
        "import benchmark.generators.train_scan as a\n"
        "import benchmark.generators.window_stream as b\n"
        "from cvssl_tpu_torch.train.engine import Engine\n"
        "from cvssl_tpu_torch.data import device_store\n"
        "from cvssl_tpu_torch.eval import val3d\n"
        "from benchmark import spec\n"
        "for m in spec.benchmark()['end_to_end'] + "
        "spec.benchmark()['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "cvssl_tpu_torch" in names and "benchmark" in names
    assert not names & FORBIDDEN


def test_run_without_a_card_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "acdc2d-mt-graphed", "--seed", "1", "--seconds", "1", "--trace",
         "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_alone_fails(tmp_path):
    """In a folder with BENCHMARK.json and benchmark/ only, a run fails."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "brats3d-window",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
