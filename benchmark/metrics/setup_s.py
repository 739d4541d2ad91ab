"""setup_s (s): process start to the window's start, compilation and warm-up
included."""
from benchmark.readers import setup_s as read  # noqa: F401
