"""Drop-in object API mirroring the reference's public classes.

A stainlib user should find every class they use, with the same names,
constructor signatures and fit/transform (or fit/pop) contracts as
``stainlib/__init__.py:19-30`` exports — but executing on the accelerator
via the batched functional core underneath. Single uint8 numpy images go in
and come out, exactly like the reference; for throughput, use the functional
modules directly on tile batches (these wrappers add one host round trip
per call by design).

Class -> reference mapping:
  * ``LuminosityThresholdTissueLocator``  -> ``stain_utils.py:29-48``
  * ``LuminosityStandardizer``            -> ``stain_utils.py:50-67``
  * ``MacenkoStainExtractor``             -> ``macenko_stain_extractor.py:5-44``
  * ``VahadaneStainExtractor``            -> ``vahadane_stain_extractor.py:16-43``
  * ``ExtractiveStainNormalizer``         -> ``normalizer.py:16-50``
  * ``ReinhardStainNormalizer``           -> ``normalizer.py:54-94``
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from stainlib_tpu.exceptions import TissueMaskException
from stainlib_tpu.normalization import extractive as _extractive
from stainlib_tpu.normalization import reinhard as _reinhard
from stainlib_tpu.extraction.macenko import stain_matrix_macenko
from stainlib_tpu.extraction.vahadane import stain_matrix_vahadane
from stainlib_tpu.ops import tissue as _tissue
from stainlib_tpu.ops.colorspace import to_uint8
from stainlib_tpu.ops.lasso import get_concentrations as _get_concentrations


def _check_uint8_image(I):
    if not (isinstance(I, np.ndarray) and I.ndim == 3 and I.dtype == np.uint8):
        raise AssertionError("Image should be RGB uint8.")


@jax.jit
def _mask_count(I, luminosity_threshold):
    return _tissue.tissue_mask(I, luminosity_threshold).count


def _require_tissue(I, luminosity_threshold: float = 0.8):
    """The reference paths that (re-)estimate a stain matrix or mask the
    background call ``get_tissue_mask``, which raises on an empty mask
    (``normalizer.py:45,85`` -> ``stain_utils.py:46-47``). One jitted
    scalar count keeps the single-image object layer's contract."""
    if int(_mask_count(jnp.asarray(I), luminosity_threshold)) == 0:
        raise TissueMaskException("Empty tissue mask computed")


class LuminosityThresholdTissueLocator:
    """Boolean tissue mask by LAB-luminosity threshold."""

    @staticmethod
    def get_tissue_mask(I, luminosity_threshold: float = 0.8):
        _check_uint8_image(I)
        tm = _tissue.tissue_mask(jnp.asarray(I), luminosity_threshold)
        if int(tm.count) == 0:
            raise TissueMaskException("Empty tissue mask computed")
        return np.asarray(tm.mask)


class LuminosityStandardizer:
    """Percentile luminosity saturation (``stain_utils.py:50-67``)."""

    @staticmethod
    def standardize(I, percentile: float = 95):
        _check_uint8_image(I)
        out = _tissue.luminosity_standardize(jnp.asarray(I), percentile)
        return np.asarray(to_uint8(out))


class MacenkoStainExtractor:
    @staticmethod
    def get_stain_matrix(I, luminosity_threshold=0.8, angular_percentile=99):
        _check_uint8_image(I)
        M = stain_matrix_macenko(jnp.asarray(I), luminosity_threshold,
                                 angular_percentile)
        M = np.asarray(M)
        if np.isnan(M).any():
            raise TissueMaskException("Empty tissue mask computed")
        return M


class VahadaneStainExtractor:
    @staticmethod
    def get_stain_matrix(I, luminosity_threshold=0.8, regularizer=0.1):
        _check_uint8_image(I)
        M = stain_matrix_vahadane(jnp.asarray(I), luminosity_threshold,
                                  regularizer)
        M = np.asarray(M)
        if np.isnan(M).any():
            raise TissueMaskException("Empty tissue mask computed")
        return M


def get_concentrations(I, stain_matrix, regularizer: float = 0.01):
    """Per-pixel stain concentrations, flattened to (H*W, 2) like
    ``stain_utils.py:69-78``."""
    C = _get_concentrations(jnp.asarray(I), jnp.asarray(stain_matrix),
                            regularizer)
    return np.asarray(C).reshape(-1, 2)


class ExtractiveStainNormalizer:
    """fit/transform stain normalization (``normalizer.py:16-50``)."""

    def __init__(self, method: str):
        method = method.lower()
        if method not in ("macenko", "vahadane"):
            raise Exception("Method not recognized.")
        self.method = method
        self._params: _extractive.ExtractiveParams | None = None

    def fit(self, target):
        _check_uint8_image(target)
        self._params = jax.tree.map(
            jax.block_until_ready,
            _extractive.fit(jnp.asarray(target), method=self.method),
        )
        if bool(jnp.isnan(self._params.stain_matrix_target).any()):
            raise TissueMaskException("Empty tissue mask computed")

    # Reference attribute names, for drop-in compatibility.
    @property
    def stain_matrix_target(self):
        return np.asarray(self._params.stain_matrix_target)

    @property
    def maxC_target(self):
        return np.asarray(self._params.max_c_target).reshape(1, 2)

    def transform(self, I):
        _check_uint8_image(I)
        if self._params is None:
            raise RuntimeError("Call fit(target) before transform().")
        # transform re-estimates the source stain matrix, which raises on
        # an empty tissue mask in the reference (normalizer.py:45).
        _require_tissue(I)
        out = _extractive.transform_jit(self._params, jnp.asarray(I),
                                        method=self.method)
        return np.asarray(out)


class ReinhardStainNormalizer:
    """fit/transform Reinhard LAB transfer (``normalizer.py:54-94``)."""

    def __init__(self, target_means=0, target_stds=0):
        self.target_means = target_means
        self.target_stds = target_stds
        self._params: _reinhard.ReinhardParams | None = None

    def fit(self, target):
        _check_uint8_image(target)
        self._params = jax.tree.map(
            jax.block_until_ready, _reinhard.fit(jnp.asarray(target))
        )
        self.target_means = np.asarray(self._params.means)
        self.target_stds = np.asarray(self._params.stds)

    def transform(self, I, mask_background: bool = False,
                  luminosity_threshold: float = 0.8):
        _check_uint8_image(I)
        if self._params is None:
            raise RuntimeError("Call fit(target) before transform().")
        if mask_background:
            # The reference's background-masking branch calls
            # get_tissue_mask, which raises on an empty mask
            # (normalizer.py:85-90).
            _require_tissue(I, luminosity_threshold)
        out = _reinhard.transform_jit(
            self._params, jnp.asarray(I), mask_background=mask_background,
            luminosity_threshold=luminosity_threshold,
        )
        return np.asarray(out)
