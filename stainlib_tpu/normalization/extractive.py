"""Extractive (Macenko / Vahadane) stain normalization, batched end to end.

Batched re-design of ``ExtractiveStainNormalizer``
(``stainlib/normalization/normalizer.py:16-50``): fit stores the target stain
matrix, plus the 99th-percentile concentration per stain; transform
re-estimates the source stain matrix per image, solves the (exact) lasso for
source concentrations, rescales by maxC_target/maxC_source and reconstructs
``255 * exp(-C @ M_target)``. Every step is a pure batched function; the
whole transform jits into a handful of fused kernels per tile batch instead
of two native SPAMS calls per image.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST

from stainlib_tpu.extraction.macenko import stain_matrix_macenko
from stainlib_tpu.extraction.vahadane import stain_matrix_vahadane
from stainlib_tpu.ops.colorspace import to_uint8
from stainlib_tpu.ops.lasso import get_concentrations
from stainlib_tpu.ops.percentile import percentile

_EXTRACTORS = {
    "macenko": stain_matrix_macenko,
    "vahadane": stain_matrix_vahadane,
}


class ExtractiveParams(NamedTuple):
    """Fitted target state (``normalizer.py:27-37``)."""

    stain_matrix_target: jnp.ndarray  # (..., 2, 3)
    max_c_target: jnp.ndarray  # (..., 2) 99th-pct concentration per stain


def fit(target_rgb, method: str = "macenko", regularizer: float = 0.01,
        **extractor_kwargs) -> ExtractiveParams:
    """Fit to a target image (..., H, W, 3); see ``normalizer.py:27-37``."""
    extractor = _EXTRACTORS[method.lower()]
    M = extractor(target_rgb, **extractor_kwargs)
    C = get_concentrations(target_rgb, M, regularizer)
    lead = C.shape[:-3]
    C = C.reshape(lead + (-1, 2))
    max_c = percentile(C, 99.0, axis=-2)
    return ExtractiveParams(stain_matrix_target=M, max_c_target=max_c)


def transform(params: ExtractiveParams, rgb, method: str = "macenko",
              regularizer: float = 0.01, **extractor_kwargs):
    """Normalize a tile batch toward the fitted target (``normalizer.py:39-50``).

    (..., H, W, 3) RGB in [0,255] -> uint8 RGB. The source stain matrix is
    re-estimated per image, exactly like the reference.
    """
    extractor = _EXTRACTORS[method.lower()]
    M_src = extractor(rgb, **extractor_kwargs)
    C = get_concentrations(rgb, M_src, regularizer)  # (..., H, W, 2)
    lead = C.shape[:-3]
    flat = C.reshape(lead + (-1, 2))
    max_c_src = percentile(flat, 99.0, axis=-2)  # (..., 2)
    scale = params.max_c_target / jnp.maximum(max_c_src, 1e-8)
    C = C * scale[..., None, None, :]
    od = jnp.einsum("...hwk,...kc->...hwc", C, params.stain_matrix_target, precision=_HI)
    return to_uint8(255.0 * jnp.exp(-od))


# Jitted fast path for the default configuration (kwargs must be static-free).
transform_jit = jax.jit(transform, static_argnames=("method", "regularizer"))


def transform_with_matrix(rgb, stain_matrix_src, max_c_src,
                          params: ExtractiveParams,
                          regularizer: float = 0.01):
    """Normalize with a FIXED source stain matrix / maxC instead of
    re-estimating per image — ``normalizer.py:46-50`` with the estimation
    hoisted out of the loop. This is the slide-level WSI transform
    (``normalization/slide.py``): estimating one stain matrix per slide
    (the physical reality — one staining batch per slide) removes the
    tile-boundary stain discontinuities that per-tile re-estimation
    produces on adjacent tiles.

    (..., H, W, 3) RGB in [0,255] -> uint8 RGB.
    """
    C = get_concentrations(rgb, stain_matrix_src, regularizer)
    scale = params.max_c_target / jnp.maximum(
        jnp.asarray(max_c_src, jnp.float32), 1e-8)
    C = C * scale[..., None, None, :]
    od = jnp.einsum("...hwk,...kc->...hwc", C, params.stain_matrix_target,
                    precision=_HI)
    return to_uint8(255.0 * jnp.exp(-od))


transform_with_matrix_jit = jax.jit(
    transform_with_matrix, static_argnames=("regularizer",))


def estimate_source(rgb, method: str = "macenko", regularizer: float = 0.01,
                    **extractor_kwargs):
    """Whole-field source estimation: (stain matrix, 99th-pct maxC) — the
    per-image half of ``transform`` (``normalizer.py:45-48``) with nothing
    applied. ``rgb``: (..., H, W, 3). Any field size: large reduction axes
    ride the streaming count-bisection percentiles (``ops/percentile.py``).
    """
    extractor = _EXTRACTORS[method.lower()]
    M_src = extractor(rgb, **extractor_kwargs)
    C = get_concentrations(rgb, M_src, regularizer)
    lead = C.shape[:-3]
    max_c_src = percentile(C.reshape(lead + (-1, 2)), 99.0, axis=-2)
    return M_src, max_c_src


def reconstruct(concentrations, stain_matrix):
    """``255 * exp(-C @ M)`` -> uint8; shared by the normalizer
    (``normalizer.py:49-50``) and the stain augmenter (``augmenter.py:445-448``)."""
    od = jnp.einsum("...k,...kc->...c", concentrations, stain_matrix, precision=_HI)
    return to_uint8(255.0 * jnp.exp(-od))
