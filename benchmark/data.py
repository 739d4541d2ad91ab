"""The benchmark's inputs, all drawn from ``--seed``: the train slices and
volumes, the index rows of the two-stream batches, the resident volumes
of the sliding window, and the weights.

Images follow SSL4MIS's blob recipe: noise N(0.3, 0.1), per foreground
class one disc (2D) or ball (3D) of radius min(shape) // 6 at a centre in
the middle half of each axis, +0.2 c inside, clipped to [0, 1]; labels the
discs' classes. Images are drawn on the card in a few large calls and
rounded to bfloat16 values (kept in float32), so the program's bfloat16
stores hold the benchmark's inputs exactly and a comparison sees only the
computation. Each stream has its own generator, seeded from (seed,
stream) through numpy's SeedSequence, so any seed up to 2**64 serves.
"""
from __future__ import annotations

import numpy as np
import torch

STREAMS = {"slices": 1, "volumes": 2, "rows": 3, "weights": 4,
           "window": 5}


def stream_seed(seed: int, stream: str, part: int = 0) -> int:
    ss = np.random.SeedSequence([int(seed), STREAMS[stream], int(part)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: str, device, part: int = 0):
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream, part))
    return g


def blobs(n: int, shape, classes: int, gen: torch.Generator, device):
    """``n`` blob images (n, *shape) float32 with bfloat16 values and their
    labels (n, *shape) uint8."""
    shape = tuple(int(s) for s in shape)
    image = 0.3 + 0.1 * torch.randn((n,) + shape, generator=gen,
                                    device=device)
    label = torch.zeros((n,) + shape, dtype=torch.uint8, device=device)
    radius = max(min(shape) // 6, 2)
    for c in range(1, classes):
        dist = torch.zeros((n,) + (1,) * len(shape), device=device)
        for ax, s in enumerate(shape):
            ctr = torch.randint(s // 4, 3 * s // 4, (n,), generator=gen,
                                device=device)
            view = [n] + [1] * len(shape)
            pos = torch.arange(s, device=device).view(
                [1] * (ax + 1) + [s] + [1] * (len(shape) - ax - 1))
            dist = dist + (pos - ctr.view(view)).float() ** 2
        mask = dist <= radius ** 2
        label[mask] = c
        image = image + (0.2 * c) * mask
    return image.clamp_(0.0, 1.0).bfloat16().float(), label


class VolumeSet:
    """``n`` blob volumes drawn in chunks of ``chunk``, each chunk from its
    own generator, so that any volume can be drawn again alone: the train
    store reads them one by one, the reference reads the few it needs."""

    def __init__(self, n: int, shape, classes: int, seed: int, device,
                 stream: str = "volumes", chunk: int = 25):
        self.n, self.shape, self.classes = n, tuple(shape), classes
        self.seed, self.device, self.stream = seed, device, stream
        self.chunk = chunk
        self._cached = (None, None)

    def __len__(self):
        return self.n

    def _chunk(self, c: int):
        if self._cached[0] != c:
            size = min(self.chunk, self.n - c * self.chunk)
            gen = generator(self.seed, self.stream, self.device, part=c)
            self._cached = (c, blobs(size, self.shape, self.classes, gen,
                                     self.device))
        return self._cached[1]

    def __getitem__(self, i: int) -> dict:
        image, label = self._chunk(i // self.chunk)
        j = i % self.chunk
        return {"image": image[j], "label": label[j]}

    def forget(self):
        """Drop the chunk drawn last."""
        self._cached = (None, None)

    def gather(self, indices) -> dict:
        """Images and labels of ``indices`` stacked, on the device."""
        items = [{k: v.clone() for k, v in self[int(i)].items()}
                 for i in indices]
        self.forget()
        return {"images": torch.stack([s["image"] for s in items]),
                "labels": torch.stack([s["label"] for s in items])}


def index_rows(rows: int, labeled: int, total: int, batch: int,
               labeled_bs: int, seed: int) -> np.ndarray:
    """(rows, batch) int64 indices: each row ``labeled_bs`` labeled indices
    from [0, labeled) and the rest from [labeled, total), both streams
    walking fresh random permutations (SSL4MIS's TwoStreamBatchSampler)."""
    rng = np.random.default_rng(stream_seed(seed, "rows"))

    def stream(lo, hi, per_row):
        need = rows * per_row
        out = []
        while sum(len(p) for p in out) < need:
            out.append(lo + rng.permutation(hi - lo))
        return np.concatenate(out)[:need].reshape(rows, per_row)
    return np.concatenate([stream(0, labeled, labeled_bs),
                           stream(labeled, total, batch - labeled_bs)],
                          axis=1).astype(np.int64)


def weights(model, config: dict, seed: int, device):
    """The student's and the teacher's weights, float32 on the device, under
    the module names of the reference ``model``: the teacher is the student
    plus a tenth of another draw, as a teacher that trails its student."""
    specs = model.param_specs(config["in_channels"], config["num_classes"])
    from benchmark.reference import layers
    gen = generator(seed, "weights", device)
    student = layers.init_weights(specs, gen, device)
    teacher = layers.init_weights(specs, gen, device, base=student,
                                  spread=0.1)
    return student, teacher
