"""Drop-in object API contract tests (reference class semantics)."""

import numpy as np
import pytest

import stainlib_tpu as sl
from tests.synth import he_patch


def test_public_exports_match_reference():
    # Everything stainlib/__init__.py:19-30 exports has a counterpart.
    for name in [
        "MacenkoStainExtractor",
        "VahadaneStainExtractor",
        "ExtractiveStainNormalizer",
        "ReinhardStainNormalizer",
        "LuminosityStandardizer",
        "TissueMaskException",
    ]:
        assert hasattr(sl, name)


def test_asserts_on_non_uint8():
    with pytest.raises(AssertionError):
        sl.MacenkoStainExtractor.get_stain_matrix(
            np.zeros((8, 8, 3), np.float32)
        )


def test_tissue_mask_exception_on_white():
    white = np.full((16, 16, 3), 255, np.uint8)
    with pytest.raises(sl.TissueMaskException):
        sl.LuminosityThresholdTissueLocator.get_tissue_mask(white)
    with pytest.raises(sl.TissueMaskException):
        sl.MacenkoStainExtractor.get_stain_matrix(white)


def test_transform_raises_on_white():
    """transform re-estimates the source matrix, so a tissue-free image
    raises like the reference (normalizer.py:45 -> stain_utils.py:46-47);
    Reinhard only masks tissue when mask_background=True
    (normalizer.py:85-90)."""
    white = np.full((16, 16, 3), 255, np.uint8)
    norm = sl.ExtractiveStainNormalizer(method="macenko")
    norm.fit(he_patch(48, 48, seed=50))
    with pytest.raises(sl.TissueMaskException):
        norm.transform(white)

    rn = sl.ReinhardStainNormalizer()
    rn.fit(he_patch(48, 48, seed=51))
    rn.transform(white)  # no masking: the reference does not raise
    with pytest.raises(sl.TissueMaskException):
        rn.transform(white, mask_background=True)


def test_extractive_normalizer_macenko_roundtrip():
    norm = sl.ExtractiveStainNormalizer(method="macenko")
    norm.fit(he_patch(48, 48, seed=50))
    out = norm.transform(he_patch(48, 48, seed=51))
    assert out.shape == (48, 48, 3) and out.dtype == np.uint8
    assert norm.stain_matrix_target.shape == (2, 3)
    assert norm.maxC_target.shape == (1, 2)


def test_extractive_normalizer_rejects_unknown_method():
    with pytest.raises(Exception):
        sl.ExtractiveStainNormalizer(method="nope")


def test_reinhard_normalizer_object():
    norm = sl.ReinhardStainNormalizer()
    norm.fit(he_patch(48, 48, seed=52))
    out = norm.transform(he_patch(48, 48, seed=53))
    assert out.shape == (48, 48, 3) and out.dtype == np.uint8
    assert np.asarray(norm.target_means).shape == (3,)


def test_luminosity_standardizer_object():
    out = sl.LuminosityStandardizer.standardize(he_patch(32, 32, seed=54))
    assert out.dtype == np.uint8 and out.shape == (32, 32, 3)


def test_get_concentrations_function():
    img = he_patch(32, 32, seed=55)
    M = sl.MacenkoStainExtractor.get_stain_matrix(img)
    C = sl.get_concentrations(img, M)
    assert C.shape == (32 * 32, 2) and (C >= 0).all()


def test_vahadane_extractor_and_normalizer_class():
    img = he_patch(48, 48, seed=56)
    M = sl.VahadaneStainExtractor.get_stain_matrix(img)
    assert M.shape == (2, 3) and (M >= 0).all()
    assert abs(np.linalg.norm(M, axis=1) - 1).max() < 1e-5
    norm = sl.ExtractiveStainNormalizer("vahadane")
    norm.fit(he_patch(48, 48, seed=57))
    out = norm.transform(img)
    assert out.shape == img.shape and out.dtype == np.uint8
