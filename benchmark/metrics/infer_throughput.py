"""infer_throughput (volumes/s): label maps delivered to the host in the
window, over the window."""
from benchmark.readers import volumes_per_s as read  # noqa: F401
