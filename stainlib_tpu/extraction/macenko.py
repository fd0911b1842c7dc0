"""Macenko stain-matrix estimation, batched and jit-compiled.

Batched JAX re-design of ``stainlib/extraction/macenko_stain_extractor.py:5-44``
(M. Macenko et al., 'A method for normalizing histology slides for
quantitative analysis'): tissue-masked OD covariance -> closed-form 3x3
eigenvectors -> angular percentiles -> two extreme stain vectors -> H-first
ordering -> row normalization. Differences from the reference are purely
structural: the boolean-gather tissue mask becomes a weighted (static-shape)
covariance, ``np.linalg.eigh`` becomes the analytic
:func:`stainlib_tpu.ops.linalg3.eigh3x3`, and the percentile over masked
angles uses the +inf-sentinel sort of
:func:`stainlib_tpu.ops.percentile.masked_percentile`. Everything vmaps over a
leading tile batch.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST

from stainlib_tpu.ops.colorspace import rgb_to_od
from stainlib_tpu.ops.linalg3 import eigh3x3
from stainlib_tpu.ops.percentile import masked_percentile
from stainlib_tpu.ops.tissue import tissue_mask


def stain_matrix_macenko(
    rgb,
    luminosity_threshold: float = 0.8,
    angular_percentile: float = 99.0,
):
    """Estimate the 2x3 H&E stain matrix per image.

    Args:
      rgb: (..., H, W, 3) RGB in [0,255] (float or uint8).
    Returns:
      (..., 2, 3) row-normalized stain matrix, Haematoxylin first
      (red-OD-dominant row, per ``macenko_stain_extractor.py:38-43``).
      Images with an empty tissue mask yield NaN rows (the functional
      equivalent of ``TissueMaskException``; see object API for the raise).
    """
    rgb = jnp.asarray(rgb)
    mask = tissue_mask(rgb, luminosity_threshold).mask
    od = rgb_to_od(rgb)
    lead = od.shape[:-3]
    n_pix = od.shape[-3] * od.shape[-2]
    od = od.reshape(lead + (n_pix, 3))
    m = mask.reshape(lead + (n_pix,)).astype(jnp.float32)
    return stain_matrix_macenko_from_od(od, m, angular_percentile)


def stain_matrix_macenko_from_od(od, m, angular_percentile: float = 99.0):
    """Macenko estimation from precomputed flattened OD (..., N, 3) and
    float tissue weights (..., N) — lets callers that already hold both
    (e.g. the Vahadane warm start) skip recomputing mask/OD."""
    # Weighted covariance over tissue pixels; denominator N-1 matches np.cov
    # (rowvar=False) at macenko_stain_extractor.py:22.
    n = jnp.sum(m, axis=-1)
    safe_n = jnp.maximum(n, 1.0)
    mean = jnp.einsum("...n,...nc->...c", m, od, precision=_HI) / safe_n[..., None]
    diff = (od - mean[..., None, :]) * m[..., None]
    cov = jnp.einsum("...nc,...nd->...cd", diff, od - mean[..., None, :], precision=_HI)
    cov = cov / jnp.maximum(n - 1.0, 1.0)[..., None, None]

    # Top-2 eigenvectors (ascending order -> columns [2, 1]); sign convention
    # of the reference: first (red) component non-negative
    # (macenko_stain_extractor.py:25-27).
    _, V = eigh3x3(cov)
    V2 = V[..., :, (2, 1)]
    sign = jnp.where(V2[..., 0:1, :] < 0.0, -1.0, 1.0)
    V2 = V2 * sign

    # Project tissue OD on the plane, take angular percentiles.
    That = jnp.einsum("...nc,...ck->...nk", od, V2, precision=_HI)
    phi = jnp.arctan2(That[..., 1], That[..., 0])
    mask_b = m > 0.0
    # One vectorized call: on large fields both angle bounds share every
    # count-bisection traversal instead of running two sequential loops.
    min_phi, max_phi = masked_percentile(
        phi, mask_b,
        jnp.asarray([100.0 - angular_percentile, angular_percentile],
                    jnp.float32))

    v1 = jnp.einsum(
        "...ck,...k->...c",
        V2,
        jnp.stack([jnp.cos(min_phi), jnp.sin(min_phi)], axis=-1),
        precision=_HI,
    )
    v2 = jnp.einsum(
        "...ck,...k->...c",
        V2,
        jnp.stack([jnp.cos(max_phi), jnp.sin(max_phi)], axis=-1),
        precision=_HI,
    )

    # H first: the row with the larger red OD (macenko_stain_extractor.py:40-43).
    first = v1[..., 0] > v2[..., 0]
    h = jnp.where(first[..., None], v1, v2)
    e = jnp.where(first[..., None], v2, v1)
    HE = jnp.stack([h, e], axis=-2)
    HE = HE / jnp.linalg.norm(HE, axis=-1, keepdims=True)

    # Empty tissue mask -> NaN sentinel (reference raises TissueMaskException).
    return jnp.where((n > 0.0)[..., None, None], HE, jnp.nan)
