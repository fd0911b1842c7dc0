"""Stateless, PRNG-keyed stain/color augmentation kernels.

Batched JAX re-design of ``stainlib/augmentation/augmenter.py`` and the DANN
RGB jitter (``dlmodels/stain_adversarial_learning/utils/utils_patches.py:
33-50``). The reference mutates global ``np.random`` state between
``randomize()``/``transform()`` (or draws inside ``pop()``); here every
augmentation is a pure function of ``(params, batch, key)`` with per-sample
key splitting, so it jits into the training input pipeline and vmaps over the
batch axis (SURVEY.md section 3.2).

All entry points take (..., H, W, 3) RGB in [0,255] and return uint8.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from stainlib_tpu.extraction.macenko import stain_matrix_macenko
from stainlib_tpu.extraction.vahadane import stain_matrix_vahadane
from stainlib_tpu.normalization.extractive import reconstruct
from stainlib_tpu.ops.colorspace import (
    hed_to_rgb,
    rgb_to_gray,
    rgb_to_hed,
    to_uint8,
)
from stainlib_tpu.ops.lasso import get_concentrations
from stainlib_tpu.ops.tissue import tissue_mask

Range = Optional[Tuple[float, float]]


def _uniform(key, lead, ranges: Sequence[Range], none_value: float):
    """Per-image draws for three channel ranges; ``None`` -> ``none_value``.

    Mirrors ``HedColorAugmenter.randomize`` (``augmenter.py:333-344``) but
    vectorized over the batch: one independent draw per image per channel.
    """
    lows = jnp.asarray([r[0] if r is not None else none_value for r in ranges])
    highs = jnp.asarray([r[1] if r is not None else none_value for r in ranges])
    u = jax.random.uniform(key, lead + (3,), jnp.float32)
    return lows + u * (highs - lows)


# --------------------------------------------------------------------------
# HED jitter (augmenter.py:86-344 + presets :346-372)
# --------------------------------------------------------------------------


def hed_jitter_apply(rgb, sigmas, biases, cutoff_range=(0.0, 1.0)):
    """Apply given per-image HED sigma/bias (``augmenter.py:276-326``).

    ``sigmas``/``biases``: (..., 3) per-image H/E/D parameters. Patches whose
    mean (RGB/255) falls outside ``cutoff_range`` pass through unchanged
    (``augmenter.py:287-293``) — a branch in the reference, a select here.
    """
    x = jnp.asarray(rgb, jnp.float32)
    hed = rgb_to_hed(x)
    hed = hed * (1.0 + sigmas[..., None, None, :]) + biases[..., None, None, :]
    out = hed_to_rgb(hed)
    patch_mean = jnp.mean(x, axis=(-3, -2, -1)) / 255.0
    inside = (cutoff_range[0] <= patch_mean) & (patch_mean <= cutoff_range[1])
    return to_uint8(jnp.where(inside[..., None, None, None], out, x))


def hed_jitter(
    rgb,
    key,
    haematoxylin_sigma_range: Range = (-0.1, 0.1),
    haematoxylin_bias_range: Range = (-0.1, 0.1),
    eosin_sigma_range: Range = (-0.1, 0.1),
    eosin_bias_range: Range = (-0.1, 0.1),
    dab_sigma_range: Range = (-0.1, 0.1),
    dab_bias_range: Range = (-0.1, 0.1),
    cutoff_range: Tuple[float, float] = (0.0, 1.0),
):
    """randomize() + transform() fused: fresh per-image draws from the ranges."""
    lead = jnp.shape(rgb)[:-3]
    k_s, k_b = jax.random.split(key)
    sigmas = _uniform(
        k_s, lead, [haematoxylin_sigma_range, eosin_sigma_range, dab_sigma_range], 0.0
    )
    biases = _uniform(
        k_b, lead, [haematoxylin_bias_range, eosin_bias_range, dab_bias_range], 0.0
    )
    return hed_jitter_apply(rgb, sigmas, biases, cutoff_range)


def hed_preset(thresh: float):
    """Symmetric preset of ``HedColorAugmenter1`` (``augmenter.py:346-360``):
    all six ranges (-thresh, thresh), cutoff (0.05, 0.95)."""
    r = (-thresh, thresh)
    return dict(
        haematoxylin_sigma_range=r,
        haematoxylin_bias_range=r,
        eosin_sigma_range=r,
        eosin_bias_range=r,
        dab_sigma_range=r,
        dab_bias_range=r,
        cutoff_range=(0.05, 0.95),
    )


def hed_lighter(rgb, key):
    """``HedLighterColorAugmenter`` preset, thresh=0.03 (``augmenter.py:362``)."""
    return hed_jitter(rgb, key, **hed_preset(0.03))


def hed_light(rgb, key):
    """``HedLightColorAugmenter`` preset, thresh=0.1 (``augmenter.py:366``)."""
    return hed_jitter(rgb, key, **hed_preset(0.1))


def hed_strong(rgb, key):
    """``HedStrongColorAugmenter`` preset, thresh=1.0 (``augmenter.py:370``)."""
    return hed_jitter(rgb, key, **hed_preset(1.0))


# --------------------------------------------------------------------------
# Grayscale (augmenter.py:374-401)
# --------------------------------------------------------------------------


def grayscale_augment(rgb, key):
    """Per-image alpha~U(0.8,1.2), beta~U(-0.2,0.2) on skimage-luma grayscale,
    stacked back to 3 channels (``GrayscaleAugmentor.pop``,
    ``augmenter.py:390-401``; note the reference hard-codes 0.2 regardless of
    its sigma ctor args — we keep that contract in the object API)."""
    lead = jnp.shape(rgb)[:-3]
    k_a, k_b = jax.random.split(key)
    alpha = jax.random.uniform(k_a, lead, jnp.float32, 0.8, 1.2)
    beta = jax.random.uniform(k_b, lead, jnp.float32, -0.2, 0.2)
    g = rgb_to_gray(rgb)
    g = jnp.clip(g * alpha[..., None, None] + beta[..., None, None], 0.0, 1.0)
    out = jnp.stack([g, g, g], axis=-1) * 255.0
    return to_uint8(out)


# --------------------------------------------------------------------------
# Stain-concentration perturbation (augmenter.py:403-448)
# --------------------------------------------------------------------------

_EXTRACTORS = {"macenko": stain_matrix_macenko, "vahadane": stain_matrix_vahadane}


class StainAugmentParams(NamedTuple):
    """``StainAugmentor.fit`` state (``augmenter.py:416-426``)."""

    stain_matrix: jnp.ndarray  # (..., 2, 3)
    concentrations: jnp.ndarray  # (..., H, W, 2)
    mask: jnp.ndarray  # (..., H, W) bool


def stain_augment_fit(rgb, method: str = "macenko", **extractor_kwargs):
    M = _EXTRACTORS[method.lower()](rgb, **extractor_kwargs)
    C = get_concentrations(rgb, M)
    mask = tissue_mask(rgb).mask
    return StainAugmentParams(stain_matrix=M, concentrations=C, mask=mask)


def stain_augment_pop(
    params: StainAugmentParams,
    key,
    sigma1: float = 0.2,
    sigma2: float = 0.2,
    augment_background: bool = False,
):
    """One augmented draw (``StainAugmentor.pop``, ``augmenter.py:428-448``):
    per-stain alpha~U(1-sigma1,1+sigma1), beta~U(-sigma2,sigma2) applied to
    the fitted concentrations (tissue-only unless ``augment_background``)."""
    lead = params.stain_matrix.shape[:-2]
    k_a, k_b = jax.random.split(key)
    alpha = jax.random.uniform(k_a, lead + (2,), jnp.float32, 1.0 - sigma1, 1.0 + sigma1)
    beta = jax.random.uniform(k_b, lead + (2,), jnp.float32, -sigma2, sigma2)
    C = params.concentrations
    C_aug = C * alpha[..., None, None, :] + beta[..., None, None, :]
    if not augment_background:
        C_aug = jnp.where(params.mask[..., None], C_aug, C)
    return reconstruct(C_aug, params.stain_matrix[..., None, None, :, :])


def stain_augment(rgb, key, method: str = "macenko", sigma1: float = 0.2,
                  sigma2: float = 0.2, augment_background: bool = False):
    """fit + one pop in one call (for in-loop training augment); identical,
    bit for bit, to ``stain_augment_fit`` followed by ``stain_augment_pop``
    with the same key."""
    params = stain_augment_fit(rgb, method)
    return stain_augment_pop(params, key, sigma1, sigma2, augment_background)


# --------------------------------------------------------------------------
# RGB jitter (DANN pipeline, utils_patches.py:33-50)
# --------------------------------------------------------------------------


def rgb_jitter(rgb, key):
    """Per-channel a~U(0.9,1.1), b~U(-10,10) on the uint8 scale, then a
    per-image min/max rescale to [0,255] (``color_augment_patches`` +
    ``scale_range``, ``utils_patches.py:33-50,307-311``). Returns uint8."""
    x = jnp.asarray(rgb, jnp.float32)
    lead = jnp.shape(rgb)[:-3]
    k_a, k_b = jax.random.split(key)
    a = jax.random.uniform(k_a, lead + (3,), jnp.float32, 0.9, 1.1)
    b = jax.random.uniform(k_b, lead + (3,), jnp.float32, -10.0, 10.0)
    y = x * a[..., None, None, :] + b[..., None, None, :]
    y_min = jnp.min(y, axis=(-3, -2, -1), keepdims=True)
    y = y - y_min
    y_max = jnp.max(y, axis=(-3, -2, -1), keepdims=True)
    y = y / (y_max / (255.0 + 1e-5) + 1e-12)
    return to_uint8(y)
