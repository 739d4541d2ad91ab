"""mfu.uamt3d (%): the benchmark's FLOP count of a unit of work over its plain
reference, times the units of the traced window, over the window and the
card's dense bf16 peak."""
from benchmark.readers import mfu as read  # noqa: F401
