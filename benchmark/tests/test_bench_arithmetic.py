"""The benchmark's arithmetic: rates, the p95, kernel #1's bytes, the FLOP
counts, the trace's busy and idle time, and the readers."""
import types

import pytest

from benchmark import readers, trace, yardstick
from benchmark.reference import methods, window

CONFIG_2D = dict(model="unet", method="mean_teacher", in_channels=1,
                 num_classes=4, batch_size=24, labeled_bs=12,
                 patch_size=[256, 256])
CONFIG_3D = dict(model="unet_3D", method="uamt", in_channels=1,
                 num_classes=2, batch_size=4, labeled_bs=2,
                 patch_size=[96, 96, 96], uncertainty_T=8)


def test_rate_and_p95():
    assert yardstick.rate(240, 2.0) == 120.0
    # all values count: the p95 of 1..100 lies between ranks 95 and 96
    assert yardstick.p95(list(range(1, 101))) == pytest.approx(95.05)
    assert yardstick.p95([0.2] * 19 + [1.0]) == pytest.approx(0.24)


def test_ce_dice_bytes_match_the_smoke_bounds():
    """chip_smoke.py's bounds of kernel #1 at 3.35 TB/s: 2.817 / 4.695 us
    at (12, 4, 256, 256) bf16 and 4.226 / 6.338 us at (2, 2, 96^3) bf16,
    int32 labels."""
    fwd, bwd = yardstick.ce_dice_bytes((12, 4, 256, 256), 2, 4)
    assert round(fwd / 3.35e12 * 1e6, 3) == 2.817
    assert round(bwd / 3.35e12 * 1e6, 3) == 4.695
    fwd, bwd = yardstick.ce_dice_bytes((2, 2, 96, 96, 96), 2, 4)
    assert (fwd, bwd) == (14_155_808, 21_233_696)
    assert round(fwd / 3.35e12 * 1e6, 3) == 4.226
    assert round(bwd / 3.35e12 * 1e6, 3) == 6.338


def test_flop_counts_match_perf_md():
    """PERF.md's FlopCounterMode counts over the program's own steps."""
    assert methods.flop_count(CONFIG_2D) == 495_087_255_552
    assert methods.flop_count(CONFIG_3D) == 3_656_352_006_144
    corners = window.windows((140, 180, 180), (96, 96, 96), 64, 64)
    assert len(corners) == 18
    assert methods.window_flop_count(CONFIG_3D, 18, 6) == 2_195_645_792_256


def test_peaks():
    assert yardstick.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert yardstick.peaks("NVIDIA H100 PCIe")[0] == 756e12
    assert yardstick.peaks("NVIDIA A100") is None


def _trace():
    # a window of 100 us: the device busy 10-40, 42-50, 70-80 and from
    # 95 on; the host in "call" 0-59 with "launch" 38-46 inside it, then
    # in "wait" 60-100
    device = [(10, 40, "conv"), (42, 50, "norm"),
              (70, 80, "ce_dice_fwd_kernel<x>"), (95, 130, "conv")]
    host = [(0, 59, "bench.call"), (38, 46, "cudaLaunchKernel"),
            (60, 100, "bench.wait")]
    return trace.Trace(device, host, (0, 100))


def test_trace_busy_and_gaps():
    t = _trace()
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx((30 + 8 + 10 + 5) * 1e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["bench.call"] == pytest.approx(10e-6)        # 0-10
    assert gaps["bench.call/cudaLaunchKernel"] == pytest.approx(2e-6)
    assert gaps["bench.wait"] == pytest.approx((20 + 15) * 1e-6)
    assert sum(gaps.values()) == pytest.approx(t.window_s - t.busy_s)
    assert t.kernel_seconds(("ce_dice_fwd_kernel",)) == (
        pytest.approx(10e-6), 1)
    assert t.top_ops()[0] == ["conv", pytest.approx(35e-6)]


def test_readers():
    t = _trace()
    run = types.SimpleNamespace(
        kind="train", trace=t, traced_units=2, flops_per_unit=1e6,
        peak_flops=1e12, peak_bw=1e12, ce_dice_bytes=(1e6, 2e6),
        window={"samples": 480, "seconds": 2.0, "steps": 20},
        setup_s=3.0, gather_ms=None, enqueue_s=[0.01, 0.03, 0.02])
    assert readers.train_samples_per_s(run) == 240.0
    assert readers.idle_share(run) == pytest.approx(47.0)
    # 2 units of 1 MFLOP in 100 us at 1 TFLOP/s
    assert readers.mfu(run) == pytest.approx(2.0)
    # 3 MB a step at 1 TB/s: 3 us a step, 2 steps in 10 us of the kernel
    assert readers.roofline(run, ("ce_dice_fwd_kernel",)) == \
        pytest.approx(60.0)
    assert readers.roofline(run, ("absent",)) is None
    assert readers.gather_ms(run) is None
    assert readers.enqueue_ms(run) == pytest.approx(20.0)
    assert readers.volumes_per_s(run) is None
    run.kind = "window"
    run.window = {"delivered": 30, "seconds": 3.0,
                  "latencies": [0.1] * 19 + [0.3]}
    assert readers.volumes_per_s(run) == 10.0
    assert readers.latency_p95_ms(run) == pytest.approx(110.0)
    run.trace = None
    assert readers.idle_share(run) is None and readers.mfu(run) is None
