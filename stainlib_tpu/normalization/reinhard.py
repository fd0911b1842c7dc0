"""Reinhard LAB statistics transfer, batched and jit-compiled.

Batched JAX re-design of ``stainlib/normalization/normalizer.py:54-94``
(E. Reinhard et al., 'Color transfer between images'): brightness
standardization, per-channel LAB mean/std matching, optional background
masking that paints non-tissue white. The reference's per-image
OpenCV round trips (``lab_split``/``merge_back``/``cv.meanStdDev``,
``stain_utils.py:146-186``) become one fused float pipeline — uint8 in,
uint8 out, everything in between fused by XLA into a few passes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from stainlib_tpu.ops.colorspace import lab_to_rgb, rgb_to_lab, to_uint8
from stainlib_tpu.ops.percentile import mean_std
from stainlib_tpu.ops.tissue import standardize_brightness, tissue_mask


class ReinhardParams(NamedTuple):
    """Fitted target statistics (LAB units: L in [0,100], a/b centered)."""

    means: jnp.ndarray  # (..., 3)
    stds: jnp.ndarray  # (..., 3)


def _quantize_lab(lab):
    """Emulate the reference's pass through OpenCV's *uint8* LAB image:
    pack (L*2.55, a+128, b+128), round to the integer grid as ``cvRound``
    (round-half-even), clip to [0,255], unpack. The float pipeline is more
    accurate, but strict delta-E parity with CPU stainlib requires matching
    its quantization (``stain_utils.py:146-158`` operates on uint8 LAB)."""
    packed = lab * jnp.asarray([2.55, 1.0, 1.0]) + jnp.asarray([0.0, 128.0, 128.0])
    packed = jnp.clip(jnp.round(packed), 0.0, 255.0)
    return (packed - jnp.asarray([0.0, 128.0, 128.0])) / jnp.asarray([2.55, 1.0, 1.0])


def _quantize_u8(x):
    """uint8 truncation-after-clip on a float image (``np.clip().astype``)."""
    return jnp.floor(jnp.clip(x, 0.0, 255.0))


def fit(target_rgb, quantize: bool = True) -> ReinhardParams:
    """Fit to a target image/batch (``normalizer.py:64-68``): brightness-
    standardize, then per-channel LAB mean/std (population std, matching
    ``cv.meanStdDev``). ``quantize`` emulates the reference's uint8
    intermediates for bit-level parity; set False for the pure float path."""
    I = standardize_brightness(jnp.asarray(target_rgb, jnp.float32))
    if quantize:
        I = _quantize_u8(I)
    lab = rgb_to_lab(I)
    if quantize:
        lab = _quantize_lab(lab)
    means, stds = mean_std(lab, axis=(-3, -2))
    return ReinhardParams(means=means, stds=stds)


def transform(
    params: ReinhardParams,
    rgb,
    mask_background: bool = False,
    luminosity_threshold: float = 0.8,
    quantize: bool = True,
    source_stats: ReinhardParams | None = None,
    brightness_divisor=None,
):
    """Normalize a batch toward the fitted statistics (``normalizer.py:70-94``).

    (..., H, W, 3) uint8/float RGB in -> uint8 RGB out. With
    ``mask_background=True``, non-tissue pixels are painted white
    (the reference's background=254-in-L trick saturates to L=100, a=b=0
    after merge_back's x2.55 clip; we write those LAB values directly).

    ``source_stats`` / ``brightness_divisor`` replace the per-image source
    LAB statistics and the per-image 90th-percentile brightness divisor
    with fixed (e.g. slide-level) values — the estimation-hoisted variant
    used by ``normalization/slide.py`` so adjacent WSI tiles share one
    affine and show no tile-boundary seams.
    """
    I = jnp.asarray(rgb, jnp.float32)
    if brightness_divisor is None:
        I = standardize_brightness(I)
    else:
        div = jnp.maximum(jnp.asarray(brightness_divisor, jnp.float32), 1e-6)
        I = jnp.clip(I * 255.0 / div, 0.0, 255.0)
    if quantize:
        I = _quantize_u8(I)
    lab = rgb_to_lab(I)
    if quantize:
        lab = _quantize_lab(lab)
    if source_stats is None:
        means, stds = mean_std(lab, axis=(-3, -2))
    else:
        means, stds = source_stats.means, source_stats.stds
    scale = params.stds / jnp.maximum(stds, 1e-6)
    norm = (lab - means[..., None, None, :]) * scale[..., None, None, :]
    norm = norm + params.means[..., None, None, :]

    if mask_background:
        m = tissue_mask(I, luminosity_threshold).mask[..., None]
        background = jnp.asarray([100.0, 0.0, 0.0], jnp.float32)
        norm = jnp.where(m, norm, background)

    if quantize:
        # merge_back: clip + uint8 truncation in the packed LAB domain
        # (stain_utils.py:160-172), then the LAB->RGB conversion rounds.
        packed = norm * jnp.asarray([2.55, 1.0, 1.0]) + jnp.asarray([0.0, 128.0, 128.0])
        packed = jnp.floor(jnp.clip(packed, 0.0, 255.0))
        norm = (packed - jnp.asarray([0.0, 128.0, 128.0])) / jnp.asarray([2.55, 1.0, 1.0])
        return jnp.clip(jnp.round(lab_to_rgb(norm)), 0.0, 255.0).astype(jnp.uint8)
    return to_uint8(lab_to_rgb(norm))


transform_jit = jax.jit(transform, static_argnames=("mask_background", "quantize"))
