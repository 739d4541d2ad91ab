"""gather_ms.uamt3d (ms): the store's batch_fn alone at the cell's batch,
device time by CUDA events over calls queued behind a spin of the card,
before the traced window."""
from benchmark.readers import gather_ms as read  # noqa: F401
