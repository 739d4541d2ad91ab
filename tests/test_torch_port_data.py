"""The port's data path against the JAX package: the device store's
contents, ``gather_augment`` with injected draws (bit for bit), the
three-shear rotation at every angle, and the sampler's index stream."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvssl_tpu.data import device_store as jds
from cvssl_tpu.data.sampler import TwoStreamBatchSampler as JSampler
from cvssl_tpu_torch.data import device_store as tds
from cvssl_tpu_torch.data.sampler import TwoStreamBatchSampler as TSampler


class _Slices:
    """Slices of another size than the patch, so the store zooms."""

    def __init__(self, n=10, shape=(30, 32)):
        self.n, self.shape = n, shape

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        return {"image": r.normal(0.5, 0.2, self.shape).astype(np.float32),
                "label": r.integers(0, 4, self.shape).astype(np.uint8)}


def _stores(patch=(32, 32)):
    ds = _Slices()
    return (jds.DeviceSliceStore(ds, patch),
            tds.DeviceSliceStore(ds, patch, device="cpu"))


def _bf16_to_f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_store_contents_match_jax():
    js, ts = _stores()
    np.testing.assert_array_equal(ts.images.float().numpy(),
                                  _bf16_to_f32(js.images))
    np.testing.assert_array_equal(ts.labels.numpy(), np.asarray(js.labels))
    assert ts.images.dtype == torch.bfloat16 and ts.labels.dtype == torch.uint8


def _jax_composition(images, labels, indices, d):
    """``device_store.py:228-233`` with the draws given."""
    img, lab = images[indices], labels[indices]
    rf_i, rf_l = jax.vmap(jds._rotflip_one)(
        img, lab, jnp.asarray(d["k"], jnp.int32),
        jnp.asarray(d["axis"], jnp.int32))
    rot_i, rot_l = jds._rotate_shear3(img, lab,
                                      jnp.asarray(d["aidx"], jnp.int32))
    c1 = (jnp.asarray(d["u1"]) > 0.5)[:, None, None]
    c2 = (jnp.asarray(d["u2"]) > 0.5)[:, None, None]
    img = jnp.where(c1, rf_i, jnp.where(c2, rot_i, img))
    lab = jnp.where(c1, rf_l, jnp.where(c2, rot_l, lab))
    return (np.asarray(img.astype(jnp.float32)),
            np.asarray(lab.astype(jnp.int32)))


def _torch_draws(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def test_gather_augment_matches_jax_bit_for_bit():
    js, ts = _stores()
    indices = np.array([3, 0, 7, 7, 9, 1, 4, 2])
    # every branch: rot90(k)+flip(axis) for each k/axis, rotation, identity
    d = {"u1": np.array([.9, .8, .7, .6, .6, .2, .1, .3], np.float32),
         "u2": np.array([.1, .9, .2, .9, .1, .9, .8, .4], np.float32),
         "k": np.array([0, 1, 2, 3, 1, 0, 2, 3], np.int64),
         "axis": np.array([0, 1, 1, 0, 0, 1, 0, 1], np.int64),
         "aidx": np.array([0, 5, 10, 39, 20, 3, 31, 17], np.int64)}
    want_img, want_lab = _jax_composition(js.images, js.labels,
                                          jnp.asarray(indices), d)
    got = tds.gather_augment(ts.images, ts.labels, torch.from_numpy(indices),
                             _torch_draws(d))
    assert got["image"].shape == (8, 1, 32, 32)
    assert got["image"].dtype == torch.float32
    assert got["label"].dtype == torch.int32
    np.testing.assert_array_equal(got["image"][:, 0].numpy(), want_img)
    np.testing.assert_array_equal(got["label"].numpy(), want_lab)
    np.testing.assert_array_equal(got["idx"].numpy(), indices)


@pytest.mark.parametrize("hw", [(32, 32), (24, 40)])
def test_shear_rotation_matches_jax_at_every_angle(hw):
    rng = np.random.default_rng(7)
    img = rng.normal(size=(40,) + hw).astype(np.float32)
    lab = rng.integers(0, 4, (40,) + hw).astype(np.uint8)
    aidx = np.arange(40)
    want_i, want_l = jds._rotate_shear3(jnp.asarray(img, jnp.bfloat16),
                                        jnp.asarray(lab), jnp.asarray(aidx))
    got_i, got_l = tds._rotate_shear3(
        torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(lab),
        torch.from_numpy(aidx))
    np.testing.assert_array_equal(got_i.float().numpy(), _bf16_to_f32(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_store_batch_fn_draws_from_the_generator():
    _, ts = _stores()
    idx = torch.tensor([1, 2, 3, 4])
    a = ts.batch_fn(ts.arrays(), idx, torch.Generator().manual_seed(3))
    b = ts.batch_fn(ts.arrays(), idx, torch.Generator().manual_seed(3))
    assert torch.equal(a["image"], b["image"])
    assert torch.equal(a["label"], b["label"])
    draws = tds.draw_augment(4, torch.Generator().manual_seed(3), "cpu")
    c = tds.gather_augment(ts.images, ts.labels, idx, draws)
    assert torch.equal(a["image"], c["image"])
    assert torch.equal(a["label"], c["label"])


def test_sampler_index_stream_matches_jax():
    """Same seed, same stream, across several epochs of the primary."""
    args = (list(range(8)), list(range(8, 30)), 6, 4)
    j = JSampler(*args, rng=np.random.default_rng(0)).epochs()
    t = TSampler(*args, rng=np.random.default_rng(0)).epochs()
    for a, b in zip(itertools.islice(j, 20), itertools.islice(t, 20)):
        assert [int(i) for i in a] == [int(i) for i in b]
