"""enqueue_ms.infer (ms): host time of predict_volume_async up to its
return (planning, slicing and launches for one volume), the median over
the traced window."""
from benchmark.readers import enqueue_ms as read  # noqa: F401
