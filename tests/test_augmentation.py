"""Augmentation tests: functional PRNG-keyed kernels + drop-in classes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import stainlib_tpu as sl
from stainlib_tpu.augmentation import functional as F
from stainlib_tpu.exceptions import InvalidRangeError
from tests.synth import he_batch, he_patch


KEY = jax.random.PRNGKey(42)


def test_hed_jitter_shapes_and_determinism():
    batch = jnp.asarray(he_batch(3, 32, 32, seed=60))
    a = np.asarray(F.hed_light(batch, KEY))
    b = np.asarray(F.hed_light(batch, KEY))
    assert a.shape == (3, 32, 32, 3) and a.dtype == np.uint8
    assert (a == b).all()  # same key -> same draw
    c = np.asarray(F.hed_light(batch, jax.random.PRNGKey(7)))
    assert (a != c).any()  # different key -> different draw


def test_hed_jitter_zero_ranges_is_near_identity():
    img = jnp.asarray(he_patch(32, 32, seed=61))
    out = np.asarray(
        F.hed_jitter(
            img, KEY,
            haematoxylin_sigma_range=(0.0, 0.0), haematoxylin_bias_range=(0.0, 0.0),
            eosin_sigma_range=(0.0, 0.0), eosin_bias_range=(0.0, 0.0),
            dab_sigma_range=(0.0, 0.0), dab_bias_range=(0.0, 0.0),
        )
    )
    # HED round trip only (no perturbation): near-identity up to quantization.
    assert np.abs(out.astype(int) - np.asarray(img).astype(int)).max() <= 1


def test_hed_cutoff_gate_passes_through_white():
    white = jnp.asarray(np.full((2, 16, 16, 3), 255, np.uint8))
    out = np.asarray(F.hed_strong(white, KEY))  # mean=1.0 > cutoff 0.95
    assert (out == 255).all()


def test_grayscale_augment():
    batch = jnp.asarray(he_batch(2, 24, 24, seed=62))
    out = np.asarray(F.grayscale_augment(batch, KEY))
    assert out.dtype == np.uint8
    # All three channels equal (grayscale stacked).
    assert (out[..., 0] == out[..., 1]).all() and (out[..., 1] == out[..., 2]).all()
    # Per-image draws differ between batch elements.
    d0 = out[0].astype(int) - out[1].astype(int)
    assert np.abs(d0).max() > 0


def test_stain_augment_fit_pop():
    img = jnp.asarray(he_patch(48, 48, seed=63))
    params = F.stain_augment_fit(img, method="macenko")
    a = np.asarray(F.stain_augment_pop(params, KEY))
    b = np.asarray(F.stain_augment_pop(params, jax.random.PRNGKey(1)))
    assert a.shape == (48, 48, 3) and a.dtype == np.uint8
    assert (a != b).any()
    # Background (non-tissue) pixels unchanged by default: compare to the
    # zero-perturbation reconstruction.
    mask = np.asarray(params.mask)
    recon = np.asarray(
        F.stain_augment_pop(params, KEY, sigma1=0.0, sigma2=0.0)
    )
    assert (a[~mask] == recon[~mask]).all()


def test_rgb_jitter_range_and_shape():
    batch = jnp.asarray(he_batch(2, 16, 16, seed=64))
    out = np.asarray(F.rgb_jitter(batch, KEY))
    assert out.dtype == np.uint8 and out.shape == (2, 16, 16, 3)
    # scale_range maps the patch onto ~[0, 255].
    assert out.min() <= 2 and out.max() >= 250


# ---- object API -----------------------------------------------------------


def test_hed_class_randomize_transform():
    aug = sl.HedLightColorAugmenter(seed=3)
    img = he_patch(32, 32, seed=65)
    aug.randomize()
    out1 = aug.transform(img)
    assert out1.dtype == np.uint8 and out1.shape == img.shape
    # transform is deterministic until the next randomize()
    out2 = aug.transform(img)
    assert (out1 == out2).all()
    aug.randomize()
    out3 = aug.transform(img)
    assert (out1 != out3).any()


def test_hed_class_float_patch_contract():
    aug = sl.HedLighterColorAugmenter(seed=4)
    aug.randomize()
    img = he_patch(16, 16, seed=66).astype(np.float64) / 255.0
    out = aug.transform(img)
    assert out.dtype.kind == "f" and out.max() <= 1.0


def test_invalid_range_raises():
    with pytest.raises(InvalidRangeError):
        sl.HedColorAugmenter((-2.0, 0.1), None, None, None, None, None, None)
    with pytest.raises(InvalidRangeError):
        sl.HedColorAugmenter(None, None, None, None, None, None, (0.5, 0.2))


def test_grayscale_class():
    aug = sl.GrayscaleAugmentor(seed=5)
    aug.fit(he_patch(24, 24, seed=67))
    out = aug.pop()
    assert out.dtype == np.uint8 and (out[..., 0] == out[..., 1]).all()
    out2 = aug.pop()
    assert (out != out2).any()  # key advances between pops


def test_stain_augmentor_class():
    aug = sl.StainAugmentor("macenko", seed=6)
    img = he_patch(32, 32, seed=68)
    aug.fit(img)
    assert aug.stain_matrix.shape == (2, 3)
    assert aug.source_concentrations.shape == (32 * 32, 2)
    out = aug.pop()
    assert out.shape == img.shape and out.dtype == np.uint8


def test_stain_augmentor_rejects_unknown_method():
    with pytest.raises(Exception):
        sl.StainAugmentor("bogus")


def test_hed_class_initial_sigmas_are_range_lower_bounds():
    """Before randomize(), transform() applies the range LOWER bounds
    (the reference initializes _sigmas/_biases from range[0],
    augmenter.py:196-201,255-259)."""
    aug = sl.HedColorAugmenter((-0.1, 0.1), (-0.2, 0.2), (0.0, 0.0),
                               (0.0, 0.0), (0.0, 0.0), (0.0, 0.0), None)
    assert aug._sigmas == [-0.1, 0.0, 0.0]
    assert aug._biases == [-0.2, 0.0, 0.0]
    img = he_patch(16, 16, seed=70)
    out = aug.transform(img)  # deterministic without randomize()
    out2 = aug.transform(img)
    assert (out == out2).all()


def test_grayscale_fit_raises_on_white():
    white = np.full((16, 16, 3), 255, np.uint8)
    aug = sl.GrayscaleAugmentor()
    with pytest.raises(sl.TissueMaskException):
        aug.fit(white)


def test_stain_augmentor_background_mode():
    img = he_patch(32, 32, seed=71)
    aug = sl.StainAugmentor("macenko", sigma1=0.3, sigma2=0.1,
                            augment_background=True, seed=9)
    aug.fit(img)
    out = aug.pop()
    # With augment_background, even non-tissue pixels may change.
    assert out.shape == img.shape and out.dtype == np.uint8


def test_hed_randomize_none_range_semantics():
    # Reference contract (augmenter.py:333-344): a None sigma range
    # randomizes to exactly 1.0; a None bias range to 0.0. Initial values
    # (before randomize) are 0.0 for both (augmenter.py:193-201).
    aug = sl.HedColorAugmenter(
        haematoxylin_sigma_range=None, haematoxylin_bias_range=None,
        eosin_sigma_range=(-0.1, 0.1), eosin_bias_range=(-0.1, 0.1),
        dab_sigma_range=None, dab_bias_range=None, cutoff_range=None,
    )
    assert aug._sigmas[0] == 0.0 and aug._biases[0] == 0.0
    aug.randomize()
    assert aug._sigmas[0] == 1.0 and aug._sigmas[2] == 1.0
    assert aug._biases[0] == 0.0 and aug._biases[2] == 0.0
    assert -0.1 <= aug._sigmas[1] <= 0.1


@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_stain_augment_equals_fit_then_pop(method):
    # The one-call augment is the fit-once/pop-many pair, bit for bit, for
    # the same key, also when each side is compiled on its own; fresh keys
    # give fresh draws.
    img = jnp.asarray(he_batch(2, 64, 128, seed=23))
    key = jax.random.PRNGKey(5)
    got = np.asarray(jax.jit(F.stain_augment, static_argnames="method")(
        img, key, method=method))
    params = jax.jit(F.stain_augment_fit, static_argnames="method")(
        img, method=method)
    want = np.asarray(jax.jit(F.stain_augment_pop)(params, key))
    assert got.shape == img.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    other = np.asarray(F.stain_augment_pop(params, jax.random.PRNGKey(6)))
    assert (other != got).any()
