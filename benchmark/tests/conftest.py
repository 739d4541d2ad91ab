"""The benchmark's own tests, on the CPU at small sizes; run them with

    python -m pytest benchmark/tests -q

A test that needs a card is marked ``chip`` and decides inside the test
whether one is present."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# small sizes of each cell for a CPU run: the same code paths, a few
# seconds each
SMALL = {
    "acdc2d-mt-graphed": {
        "config": {"patch_size": [32, 32], "batch_size": 4, "labeled_bs": 2,
                   "train_slices": 12, "labeled_slices": 4},
        "traffic": {"scan_steps": 2, "max_steps_per_s": 200,
                    "trace_calls": 1, "gather_calls": 2}},
    "brats3d-uamt-graphed": {
        "config": {"patch_size": [16, 16, 16], "train_volumes": 6,
                   "labeled_volumes": 2, "volume_shape": [20, 24, 22]},
        "traffic": {"scan_steps": 2, "max_steps_per_s": 200,
                    "trace_calls": 1, "gather_calls": 2}},
    "brats3d-window": {
        "config": {"patch_size": [16, 16, 16]},
        "traffic": {"volumes": 2, "shape": [20, 24, 22], "stride_xy": 8,
                    "stride_z": 8, "warmup_volumes": 1, "trace_volumes": 2,
                    "check_samples": 2}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card")


def run_small(name, seed=7, control=None, seconds=0.5):
    """One CPU run of cell ``name`` at its small size: (result, checks)."""
    from benchmark import harness
    result, checks, _ = harness.execute(
        name, seed, seconds, False, device="cpu", control=control,
        overrides=SMALL[name], log=lambda msg: None)
    return result, checks


@pytest.fixture
def small():
    return run_small
