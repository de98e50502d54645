"""On-device augmentation and mixup in the port against the JAX package.

Each op of ``data/augment.py``, given the draws the JAX op makes from its
key, computes what the JAX op computes (bit for bit where both do the same
f32 arithmetic; the resampling of ``random_resized_crop`` within 1e-5, an
einsum in another order).  The port's own draws are held to their
distributions (flip rate, crop area fraction and log aspect), mixup's
blend and partner labels to the JAX step's formula, and
``build_augment``'s errors to the JAX messages.  The Trainer takes both
recipes.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlcomp_tpu.data import augment as jaug
from mlcomp_tpu_torch.data import augment as taug
from mlcomp_tpu_torch.train.loop import Trainer, beta_draw, mixup_batch

torch.set_num_threads(2)

X = np.random.default_rng(0).random((6, 20, 24, 3), np.float32)
KEY = jax.random.PRNGKey(7)


def test_hflip_equals_the_jax_op():
    flip = np.asarray(jax.random.bernoulli(KEY, 0.5, (6,)))
    want = np.asarray(jaug._hflip(KEY, jnp.asarray(X)))
    got = taug.hflip(torch.from_numpy(X), torch.from_numpy(flip)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < flip.sum() < 6


def test_pad_crop_equals_the_jax_op():
    off = np.asarray(jax.random.randint(KEY, (6, 2), 0, 2 * 4 + 1))
    want = np.asarray(jaug._pad_crop(KEY, jnp.asarray(X), 4))
    got = taug.pad_crop(torch.from_numpy(X), 4, torch.from_numpy(off).long()).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale,ratio", [((0.08, 1.0), (3 / 4, 4 / 3)), ((0.5, 0.9), (0.5, 2.0))])
def test_random_resized_crop_equals_the_jax_op(scale, ratio):
    b, h, w, _ = X.shape
    r_area, r_ratio, r_pos = jax.random.split(KEY, 3)
    area = jax.random.uniform(r_area, (b,), minval=scale[0], maxval=scale[1]) * (h * w)
    log_ratio = jax.random.uniform(r_ratio, (b,), minval=jnp.log(ratio[0]),
                                   maxval=jnp.log(ratio[1]))
    pos = jax.random.uniform(r_pos, (b, 2))
    want = np.asarray(jaug._random_resized_crop(KEY, jnp.asarray(X), scale, ratio))
    got = taug.random_resized_crop(torch.from_numpy(X), *(torch.from_numpy(np.asarray(t))
                                                          for t in (area, log_ratio, pos)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_brightness_and_contrast_equal_the_jax_ops():
    f = jax.random.uniform(KEY, (6,), minval=0.6, maxval=1.4)
    ft = torch.from_numpy(np.asarray(f))
    np.testing.assert_array_equal(taug.brightness(torch.from_numpy(X), ft).numpy(),
                                  np.asarray(jaug._brightness(KEY, jnp.asarray(X), 0.4)))
    np.testing.assert_allclose(taug.contrast(torch.from_numpy(X), ft).numpy(),
                               np.asarray(jaug._contrast(KEY, jnp.asarray(X), 0.4)),
                               rtol=0, atol=1e-6)


def test_the_draws_follow_their_distributions():
    """Flip rate 1/2; crop area fraction ~ U[scale]; log aspect ~ U[log
    ratio]; brightness factors ~ U[1-s, 1+s] (4000 images; 5 sigma)."""
    gen = torch.Generator().manual_seed(0)
    n = 4000
    x = torch.arange(2, dtype=torch.float32).reshape(1, 1, 2, 1).expand(n, 1, 2, 1).contiguous()
    flipped = taug.build_augment({"hflip": True})(gen, x)[:, 0, 0, 0] == 1.0
    assert abs(flipped.float().mean().item() - 0.5) < 5 * math.sqrt(0.25 / n)
    seen = {}
    orig = taug.random_resized_crop

    def spy(x_, area, log_ratio, pos):
        seen.update(area=area, log_ratio=log_ratio, pos=pos)
        return orig(x_, area, log_ratio, pos)

    taug.random_resized_crop = spy
    try:
        aug = taug.build_augment({"random_resized_crop": {"scale": [0.08, 1.0]},
                                  "brightness": 0.4})
        out = aug(gen, torch.ones(n, 16, 16, 1))
    finally:
        taug.random_resized_crop = orig
    frac = seen["area"] / 256.0
    assert frac.min() >= 0.08 and frac.max() <= 1.0
    assert abs(frac.mean().item() - 0.54) < 5 * (0.92 / math.sqrt(12 * n))
    lr = seen["log_ratio"]
    assert lr.min() >= math.log(3 / 4) - 1e-6 and lr.max() <= math.log(4 / 3) + 1e-6
    assert abs(lr.mean().item()) < 5 * ((math.log(4 / 3) - math.log(3 / 4)) / math.sqrt(12 * n))
    assert seen["pos"].min() >= 0 and seen["pos"].max() < 1
    # a resample of a constant image is that constant, times the factor
    factors = out.flatten(1).mean(1)
    assert factors.min() >= 0.6 - 1e-5 and factors.max() <= 1.4 + 1e-5
    assert abs(factors.mean().item() - 1.0) < 5 * (0.8 / math.sqrt(12 * n))


def test_build_augment_errors_match_the_jax_messages():
    bad = [{"flip": True}, {"crop": 4, "random_resized_crop": True},
           {"random_resized_crop": {"area": [0.1, 1.0]}}]
    for cfg in bad:
        with pytest.raises(ValueError) as want:
            jaug.build_augment(cfg)
        with pytest.raises(ValueError) as got:
            taug.build_augment(cfg)
        assert str(got.value) == str(want.value)
    assert taug.build_augment(None) is None and taug.build_augment({}) is None
    aug = taug.build_augment(True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="NHWC"):
        aug(gen, torch.zeros(2, 4, 4))
    with pytest.raises(ValueError, match="float images"):
        aug(gen, torch.zeros(2, 4, 4, 3, dtype=torch.uint8))


def test_mixup_blends_as_the_jax_step_does():
    """lam x + (1 - lam) x[perm] in f32 with the partners' labels beside;
    the dominant lambda is at least 1/2; integer or unlabeled batches are
    refused with the JAX messages."""
    lam = np.float32(0.7)
    perm = np.array([2, 0, 5, 1, 4, 3])
    y = np.arange(6, dtype=np.int32)
    xb = jnp.asarray(X)
    want = lam.astype(xb.dtype) * xb + (1.0 - jnp.asarray(lam)).astype(xb.dtype) * xb[perm]
    got = mixup_batch({"x": torch.from_numpy(X), "y": torch.from_numpy(y)},
                      torch.tensor(lam), torch.from_numpy(perm))
    np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want))
    np.testing.assert_array_equal(got["_mix_y"].numpy(), y[perm])
    np.testing.assert_array_equal(got["y"].numpy(), y)
    with pytest.raises(ValueError, match="mixup needs labeled batches"):
        mixup_batch({"x": torch.from_numpy(X)}, torch.tensor(lam), torch.from_numpy(perm))
    with pytest.raises(ValueError, match="mixup blends float inputs"):
        mixup_batch({"x": torch.zeros(6, 4, dtype=torch.int32), "y": torch.from_numpy(y)},
                    torch.tensor(lam), torch.from_numpy(perm))
    gen = torch.Generator().manual_seed(1)
    draws = np.array([beta_draw(gen, 0.4) for _ in range(2000)])
    assert draws.min() > 0 and draws.max() < 1
    # Beta(0.4, 0.4): mean 1/2, variance 1/(4 (2 a + 1)) = 0.1389
    assert abs(draws.mean() - 0.5) < 5 * math.sqrt(0.1389 / 2000)
    assert abs(draws.var() - 0.1389) < 0.02


def test_the_trainer_takes_augment_and_mixup():
    data = {"name": "synthetic_images", "height": 16, "width": 16, "num_classes": 10}
    cfg = {"model": {"name": "mnist_cnn", "features": [4], "dense": 8},
           "optimizer": {"name": "sgd", "lr": 0.01}, "metrics": ["accuracy"], "epochs": 1,
           "augment": {"random_resized_crop": True, "hflip": True, "brightness": 0.2,
                       "contrast": 0.2},
           "mixup": 0.2, "data": {"train": {**data, "n": 8, "batch_size": 4}}}
    tr = Trainer(cfg, device="cpu")
    stats = tr.fit()
    assert tr.state.step == 2 and np.isfinite(stats["train/loss"])
    with pytest.raises(ValueError, match="unknown ops"):
        Trainer({**cfg, "augment": {"cutout": 4}}, device="cpu")
