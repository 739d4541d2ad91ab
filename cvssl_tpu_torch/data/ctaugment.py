"""CTAugment (control-theory augmentation, FixMatch), host side, on PIL
images: the port's own copy of ``cvssl_tpu/data/ctaugment.py``.

Provenance: CTAugment originates in Google Research's FixMatch
(https://github.com/google-research/fixmatch, Apache License 2.0,
Copyright 2019 Google LLC); the reference vendors that file with its
Apache-2.0 header intact (``code/augmentations/ctaugment.py:1-16``). This
module is a behavioural reimplementation of the same algorithm: the op
registry, the bin counts and the rate-update constants match the Apache-2.0
original by necessity.

* an op registry with binned magnitudes and learned per-bin rates; the
  FIRST 9 registered ops are the strong pool, the other 7 the weak pool
  (``ctaugment.py:58-62``);
* ``policy(probe, weak)`` draws ``depth`` ops; ``update_rates`` moves the
  bin rates toward a proximity score;
* ``CTATransform`` (``dataset.py:153-190``): resize (order 0), the weak ops
  on the image AND the label, the strong ops on the weak image.

Images are float arrays in [0, 1], routed through uint8 PIL 'L' images as
torchvision's ToPILImage does in the reference pipeline.

The random draws. The JAX module draws from the global ``random`` and
``np.random``, so its policies and cutouts depend on whatever else used
those streams, and a checkpoint cannot restore them. The port draws from
generators of its own, with the same calls:

* ``CTAugment(seed)`` owns a ``random.Random`` and an
  ``np.random.RandomState``, both seeded with ``seed``: ``policy`` draws
  the op names from the first (``choice``) and the magnitudes and bins from
  the second (``uniform``, ``choice``); ``contrastive_consistency`` draws
  each epoch's depths from the second too (``randint``). The legacy
  ``RandomState`` gives the stream of the global ``np.random`` functions
  seeded alike, so with JAX's globals seeded as the port's generators the
  policies are the same, bit for bit.
* cutout's location comes from the ``rng`` it is given: ``CTATransform``
  owns an ``np.random.RandomState`` that only the loader draws from, in
  load order (``data/pipeline.py::DataPipeline`` saves its state with
  each batch), so the main thread's policy draws and the loader's cutout draws
  never interleave.
* :meth:`CTAugment.state_dict` holds the rates, the depths and both
  generators' states, in plain Python values (a checkpoint's meta reads
  them with ``torch.load(weights_only=True)``).
"""
from __future__ import annotations

import random
from collections import OrderedDict, namedtuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

OPS = OrderedDict()
OP = namedtuple("OP", ("f", "bins"))
# the ops that draw: they take the loader's generator as ``rng``
DRAWING_OPS = ("cutout",)


def register(*bins):
    def wrap(f):
        OPS[f.__name__] = OP(f, bins)
        return f
    return wrap


def _enhance(x, enhancer, level):
    return enhancer(x).enhance(0.1 + 1.9 * level)


def _blend_op(x, op, level):
    return Image.blend(x, op(x), level)


def _blend_filter(x, filt, level):
    return Image.blend(x, x.filter(filt), level)


# --- strong pool (the first 9 registrations) -----------------------------

@register(17)
def autocontrast(x, level):
    return _blend_op(x, ImageOps.autocontrast, level)


@register(17)
def brightness(x, level):
    return _enhance(x, ImageEnhance.Brightness, level)


@register(17)
def color(x, level):
    return _enhance(x, ImageEnhance.Color, level)


@register(17)
def contrast(x, level):
    return _enhance(x, ImageEnhance.Contrast, level)


@register(17)
def equalize(x, level):
    return _blend_op(x, ImageOps.equalize, level)


@register(17)
def smooth(x, level):
    return _blend_filter(x, ImageFilter.SMOOTH, level)


@register(17)
def blur(x, level):
    return _blend_filter(x, ImageFilter.BLUR, level)


@register(17)
def sharpness(x, level):
    return _enhance(x, ImageEnhance.Sharpness, level)


@register(17)
def cutout(x, level, rng: np.random.RandomState):
    """Zero a square at a random lower-right-biased location
    (``ctaugment.py:185-199``), drawn from ``rng`` (JAX: the global
    ``np.random``)."""
    size = 1 + int(level * min(x.size) * 0.499)
    w, h = x.size
    hl = rng.randint(low=h // 2, high=h)
    wl = rng.randint(low=h // 2, high=w)
    upper = (max(0, hl - size // 2), max(0, wl - size // 2))
    lower = (min(h, hl + size // 2), min(w, wl + size // 2))
    x = x.copy()
    px = x.load()
    for i in range(upper[0], lower[0]):
        for j in range(upper[1], lower[1]):
            px[i, j] = 0
    return x


# --- weak pool -------------------------------------------------------------

@register()
def identity(x):
    return x


@register(17, 6)
def rescale(x, scale, method):
    s = x.size
    scale *= 0.25
    crop = (scale * s[0], scale * s[1], s[0] * (1 - scale), s[1] * (1 - scale))
    methods = (Image.LANCZOS, Image.BICUBIC, Image.BILINEAR, Image.BOX,
               Image.HAMMING, Image.NEAREST)
    return x.crop(crop).resize(x.size, methods[int(method * 5.99)])


@register(17)
def rotate(x, angle):
    return x.rotate(int(np.round((2 * angle - 1) * 45)))


@register(17)
def shear_x(x, shear):
    shear = (2 * shear - 1) * 0.3
    return x.transform(x.size, Image.AFFINE, (1, shear, 0, 0, 1, 0))


@register(17)
def shear_y(x, shear):
    shear = (2 * shear - 1) * 0.3
    return x.transform(x.size, Image.AFFINE, (1, 0, 0, shear, 1, 0))


@register(17)
def translate_x(x, delta):
    delta = (2 * delta - 1) * 0.3
    return x.transform(x.size, Image.AFFINE, (1, 0, delta, 0, 1, 0))


@register(17)
def translate_y(x, delta):
    delta = (2 * delta - 1) * 0.3
    return x.transform(x.size, Image.AFFINE, (1, 0, 0, 0, 1, delta))


NUM_STRONG_OPS = 9


def _plain(state):
    """A generator state as nested lists of Python values."""
    if isinstance(state, (tuple, list)):
        return [_plain(v) for v in state]
    if isinstance(state, np.ndarray):
        return state.tolist()
    if isinstance(state, np.generic):
        return state.item()
    return state


def np_state(rng: np.random.RandomState) -> list:
    """``rng``'s state in plain Python values."""
    return _plain(rng.get_state())


def set_np_state(rng: np.random.RandomState, state) -> None:
    name, key, pos, has_gauss, cached = state
    rng.set_state((name, np.asarray(key, np.uint32), int(pos),
                   int(has_gauss), float(cached)))


def policy_to_plain(ops) -> list:
    """A policy (a list of ``OP``) as [[name, [magnitudes]], ...]."""
    return [[str(k), [float(v) for v in bins]] for k, bins in ops]


def policy_from_plain(plain) -> list:
    return [OP(k, list(bins)) for k, bins in plain]


class CTAugment:
    """(``ctaugment.py:40-122``); the draws come from the instance's own
    generators, seeded with ``seed`` (see the module docstring)."""

    def __init__(self, depth: int = 2, th: float = 0.85, decay: float = 0.99,
                 seed: int = 0):
        self.decay = decay
        self.depth = depth
        self.th = th
        self.random_depth_weak = 2
        self.random_depth_strong = 2
        self.rates = {k: tuple(np.ones(b, "f") for b in op.bins)
                      for k, op in OPS.items()}
        self.py_rng = random.Random(seed)
        self.np_rng = np.random.RandomState(seed)

    def rate_to_p(self, rate):
        p = rate + (1 - self.decay)
        p = p / p.max()
        p = p.copy()
        p[p < self.th] = 0
        return p

    def stats(self) -> str:
        """Human-readable learned-rate table (``ctaugment.py:99-110``)."""
        return "\n".join(
            "%-16s    %s" % (
                k,
                " / ".join(" ".join("%.2f" % x for x in self.rate_to_p(rate))
                           for rate in self.rates[k]))
            for k in sorted(OPS.keys()))

    def policy(self, probe: bool, weak: bool):
        keys = list(OPS.keys())
        kl = keys[NUM_STRONG_OPS:] if weak else keys[:NUM_STRONG_OPS]
        depth = self.random_depth_weak if weak else self.random_depth_strong
        v = []
        if probe:
            for _ in range(depth):
                k = self.py_rng.choice(kl)
                rnd = self.np_rng.uniform(0, 1, len(self.rates[k]))
                v.append(OP(k, rnd.tolist()))
            return v
        for _ in range(depth):
            vt = []
            k = self.py_rng.choice(kl)
            rnd = self.np_rng.uniform(0, 1, len(self.rates[k]))
            for r, bin_ in zip(rnd, self.rates[k]):
                p = self.rate_to_p(bin_)
                value = self.np_rng.choice(p.shape[0], p=p / p.sum())
                vt.append((value + r) / p.shape[0])
            v.append(OP(k, vt))
        return v

    def update_rates(self, policy, proximity: float):
        for k, bins in policy:
            for p, rate in zip(bins, self.rates[k]):
                idx = int(p * len(rate) * 0.999)
                rate[idx] = (rate[idx] * self.decay
                             + proximity * (1 - self.decay))

    # serialisation: the reference's StorableCTAugment keys, then the
    # port's depths and generators
    def state_dict(self) -> OrderedDict:
        state = OrderedDict((k, getattr(self, k))
                            for k in ("decay", "depth", "th"))
        state["rates"] = {k: [r.tolist() for r in rates]
                          for k, rates in self.rates.items()}
        state["random_depth_weak"] = self.random_depth_weak
        state["random_depth_strong"] = self.random_depth_strong
        state["py_rng"] = _plain(self.py_rng.getstate())
        state["np_rng"] = np_state(self.np_rng)
        return state

    def load_state_dict(self, state) -> None:
        self.decay, self.depth, self.th = (state[k]
                                           for k in ("decay", "depth", "th"))
        self.rates = {k: tuple(np.asarray(r, "f") for r in rates)
                      for k, rates in state["rates"].items()}
        self.random_depth_weak = int(state["random_depth_weak"])
        self.random_depth_strong = int(state["random_depth_strong"])
        version, internal, gauss = state["py_rng"]
        self.py_rng.setstate((version, tuple(internal), gauss))
        set_np_state(self.np_rng, state["np_rng"])


def cta_apply(pil_img: Image.Image, ops, rng=None):
    """``ops`` applied in order; cutout draws its location from ``rng``."""
    if ops is None:
        return pil_img
    for op, args in ops:
        kw = {"rng": rng} if op in DRAWING_OPS else {}
        pil_img = OPS[op].f(pil_img, *args, **kw)
    return pil_img


def _to_pil(arr: np.ndarray) -> Image.Image:
    """float [0,1] -> uint8 'L' (torchvision ToPILImage float semantics)."""
    return Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8),
                           mode="L")


class CTATransform:
    """(``dataset.py:153-190``): resize (order 0) -> weak ops on image AND
    label -> strong ops on the weak image. Returns float image arrays and
    int labels. ``rng`` is the loader's generator, for cutout (an
    ``np.random.RandomState``)."""

    def __init__(self, output_size, cta: CTAugment,
                 rng: np.random.RandomState):
        self.output_size = tuple(output_size)
        self.cta = cta
        self.rng = rng

    def __call__(self, sample, ops_weak, ops_strong):
        from scipy.ndimage import zoom
        image, label = sample["image"], sample["label"]
        x, y = image.shape
        image = zoom(image, (self.output_size[0] / x, self.output_size[1] / y),
                     order=0)
        label = zoom(label, (self.output_size[0] / x, self.output_size[1] / y),
                     order=0)
        img_weak = cta_apply(_to_pil(image), ops_weak, self.rng)
        img_strong = cta_apply(img_weak, ops_strong, self.rng)
        lab_pil = Image.fromarray(label.astype(np.uint8), mode="L")
        lab_aug = cta_apply(lab_pil, ops_weak, self.rng)
        return {
            "image": image.astype(np.float32),
            "image_weak": np.asarray(img_weak, np.float32) / 255.0,
            "image_strong": np.asarray(img_strong, np.float32) / 255.0,
            "label_aug": np.asarray(lab_aug, np.int32),
            "label": label.astype(np.int32),
        }
