"""The reader of ``batchnorm_share.train`` on synthetic traces: ATen's
BatchNorm kernels (the commits before the port's own) and the port's
``bnact_`` kernels both count, other kernels do not, and a trace without
either reads None."""
import types

import pytest

from benchmark import spec, trace

ATEN = ("void at::native::batch_norm_collect_statistics_kernel<...>",
        "void at::native::batch_norm_backward_kernel<c10::BFloat16, ...>")
PORT = ("void (anonymous namespace)::bnact_stats_kernel<__nv_bfloat16, 8>",
        "void (anonymous namespace)::bnact_bwd_apply_kernel<float, 4>")


def _run(names):
    # four kernels of 10 us in a window of 100 us, busy 40 us; the first
    # two carry the given names
    ops = [(0.0, 10.0, names[0]), (20.0, 30.0, names[1]),
           (40.0, 50.0, "cudnn::conv_fprop"), (60.0, 70.0, "leaky_relu")]
    return types.SimpleNamespace(trace=trace.Trace(ops, [], (0.0, 100.0)))


@pytest.mark.parametrize("names", [ATEN, PORT, (ATEN[0], PORT[1])],
                         ids=["aten", "port", "both"])
def test_reads_the_batchnorm_kernels_over_the_busy_time(names):
    read = spec.reader("batchnorm_share.train").read
    assert read(_run(names)) == pytest.approx(50.0)


def test_reads_none_without_a_trace_or_a_batchnorm_kernel():
    read = spec.reader("batchnorm_share.train").read
    assert read(types.SimpleNamespace(trace=None)) is None
    assert read(_run(("cudnn::conv_dgrad", "elementwise"))) is None


def test_is_an_entry_of_the_2d_train_cell_alone():
    entry = {m["name"]: m for m in spec.benchmark()["per_layer"]}[
        "batchnorm_share.train"]
    assert entry["workloads"] == ["acdc2d-mt-graphed"]
    assert (entry["unit"], entry["better"], entry["source"], entry["moves"],
            entry["layer"]) == ("%", "lower", "device_trace",
                                "train_throughput", "Model (whole step)")
