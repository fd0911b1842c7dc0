"""The jnp path against the plain numpy reference (stainlib_tpu/reference.py)
at the sizes users pass, and the drop-in objects at the same sizes.

Gates: at most one uint8 step at any pixel (float32 against float64 can
move a value across a rounding boundary) and mean delta-E below 1. Sizes
above 512^2 take the streaming count-bisection percentiles.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stainlib_tpu import api
from stainlib_tpu import reference as R
from stainlib_tpu.normalization import extractive, reinhard

SIZES = (63, 224, 256, 512, 1024)
METHODS = ("macenko", "vahadane", "reinhard")


@functools.lru_cache(maxsize=None)
def _target():
    return R.make_tiles(1, 256, 256, seed=99)[0]


def _image(size):
    return R.make_tiles(1, size, size, seed=size)[0]


def _reference(method, img):
    if method == "reinhard":
        return R.reinhard_transform(img, *R.reinhard_fit(_target()))
    return R.cpu_transform(img, *R.extractive_fit(_target(), method),
                           method=method)


def _assert_close(got, want):
    step = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
    assert step <= 1, step
    de = R.delta_e(got, want)
    assert de < 1.0, de


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("method", METHODS)
def test_jnp_path_matches_numpy_reference(method, size):
    img = _image(size)
    if method == "reinhard":
        params = reinhard.fit(jnp.asarray(_target()))
        got = reinhard.transform_jit(params, jnp.asarray(img))
    else:
        params = extractive.fit(jnp.asarray(_target()), method=method)
        got = extractive.transform_jit(params, jnp.asarray(img),
                                       method=method)
    _assert_close(np.asarray(got), _reference(method, img))


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("method", METHODS)
def test_dropin_object_matches_numpy_reference(method, size):
    """The drop-in objects take the same jitted transform at every size
    (no size-dependent route) and keep the reference's uint8 contract."""
    img = _image(size)
    if method == "reinhard":
        obj = api.ReinhardStainNormalizer()
        obj.fit(_target())
        direct = reinhard.transform_jit(obj._params, jnp.asarray(img))
    else:
        obj = api.ExtractiveStainNormalizer(method)
        obj.fit(_target())
        direct = extractive.transform_jit(obj._params, jnp.asarray(img),
                                          method=method)
    got = obj.transform(img)
    assert got.shape == img.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(direct))
    _assert_close(got, _reference(method, img))


def test_reference_delta_e_is_zero_on_identical_images():
    img = _image(63)
    assert R.delta_e(img, img) == 0.0
    assert R.delta_e(img, 255 - img) > 1.0


def test_reference_lab_round_trip():
    rgb = R.make_tiles(1, 32, 32, seed=3)[0].astype(np.float64)
    np.testing.assert_allclose(R.lab_to_rgb(R.rgb_to_lab(rgb)), rgb,
                               atol=1e-6)
