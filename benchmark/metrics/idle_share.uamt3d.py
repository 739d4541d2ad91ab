"""idle_share.uamt3d (%): 1 - the union of device operations over the traced
window."""
from benchmark.readers import idle_share as read  # noqa: F401
