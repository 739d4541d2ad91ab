"""infer_latency_p95 (ms): the 95th percentile over all volumes of the
window, each from its hand-over to its label map on the host."""
from benchmark.readers import latency_p95_ms as read  # noqa: F401
