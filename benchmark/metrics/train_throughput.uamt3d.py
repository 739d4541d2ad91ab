"""train_throughput.uamt3d (samples/s): 96^3 patches of all steps the
window completed, over the window, which ends after a synchronise."""
from benchmark.readers import train_samples_per_s as read  # noqa: F401
