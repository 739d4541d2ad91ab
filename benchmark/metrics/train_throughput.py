"""train_throughput (samples/s): slices of all steps the window completed,
labeled and unlabeled, over the window, which ends after a synchronise."""
from benchmark.readers import train_samples_per_s as read  # noqa: F401
