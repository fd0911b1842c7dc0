"""Color-space conversions as pure, batched JAX functions.

These replace the reference's per-image native-library calls with fused,
jit-compatible jnp math:

* OpenCV ``cv.cvtColor(RGB2LAB/LAB2RGB)`` (8-bit semantics) used by
  ``stainlib/utils/stain_utils.py:41,62,66,152,172`` — implemented here as
  float sRGB -> CIELAB (D65) with OpenCV's matrix constants and sRGB gamma,
  verified empirically to match cv2's 8-bit path within one quantization step.
* RGB <-> optical density of ``stain_utils.py:101-124`` (zero pixels clamped
  to 1, OD floored at 1e-6).
* scikit-image ``rgb2hed`` / ``hed2rgb`` (Ruifrok-Johnston deconvolution)
  used by ``stainlib/augmentation/augmenter.py:295,319``.
* scikit-image ``rgb2gray`` used by ``augmenter.py:397``.
* the RGB <-> HSD (hue-saturation-density) model used by the color-information
  flow pipeline (``dlmodels/color-information/train_img.py:415``,
  ``data_utils.py:1``).

Conventions: images are float32 arrays with trailing channel axis and RGB in
``[0, 255]`` unless stated otherwise; every function broadcasts over arbitrary
leading (batch/spatial) axes and is safe under ``jax.jit`` / ``jax.vmap``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


def _mm(a, b):
    """Small constant-matrix contraction at full float32 precision.

    Without it XLA may run a float32 product in reduced precision (TF32 on
    NVIDIA GPUs); at 3x3 the full-precision product costs nothing and the
    extra bits are required for the delta-E < 1.0 target.
    """
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)

# --------------------------------------------------------------------------
# sRGB <-> CIELAB (OpenCV constants, D65 white point)
# --------------------------------------------------------------------------

# OpenCV's RGB->XYZ matrix (ITU-R BT.709 primaries, D65).
_RGB2XYZ = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_XYZ2RGB = np.linalg.inv(_RGB2XYZ).astype(np.float32)
# D65 reference white used by OpenCV (X_n, Y_n, Z_n).
_WHITE = np.array([0.950456, 1.0, 1.088754], dtype=np.float32)

_LAB_DELTA = 0.008856  # (6/29)^3 threshold of the CIE f() function
_LAB_KAPPA = 903.3  # OpenCV's low-Y L* slope (CIE: 24389/27 ~ 903.296)


def _srgb_gamma_expand(c):
    """sRGB electro-optical transfer: gamma-encoded [0,1] -> linear [0,1]."""
    return jnp.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _srgb_gamma_compress(c):
    """Linear [0,1] -> gamma-encoded sRGB [0,1]."""
    c = jnp.maximum(c, 0.0)
    return jnp.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1.0 / 2.4) - 0.055)


def _lab_f(t):
    return jnp.where(t > _LAB_DELTA, jnp.cbrt(t), 7.787 * t + 16.0 / 116.0)


def _lab_f_inv(ft):
    t3 = ft**3
    return jnp.where(t3 > _LAB_DELTA, t3, (ft - 16.0 / 116.0) / 7.787)


def rgb_to_lab(rgb):
    """sRGB in [0,255] -> CIELAB (L in [0,100], a/b roughly [-128,127]).

    Matches OpenCV's 8-bit ``COLOR_RGB2LAB`` (``stain_utils.py:41``) after
    undoing its uint8 packing (L*255/100, a+128, b+128): the reference's
    ``lab_split`` (``stain_utils.py:146-158``) unpacks to exactly these units.
    """
    c = jnp.asarray(rgb, jnp.float32) / 255.0
    lin = _srgb_gamma_expand(c)
    xyz = _mm(lin, jnp.asarray(_RGB2XYZ.T))
    xyz = xyz / jnp.asarray(_WHITE)
    fx, fy, fz = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    L = jnp.where(fy > _LAB_DELTA, 116.0 * jnp.cbrt(fy) - 16.0, _LAB_KAPPA * fy)
    fx, fy, fz = _lab_f(fx), _lab_f(fy), _lab_f(fz)
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return jnp.stack([L, a, b], axis=-1)


def lab_to_rgb(lab):
    """CIELAB (L in [0,100]) -> sRGB float in [0,255], clipped.

    Inverse of :func:`rgb_to_lab`; matches OpenCV ``COLOR_LAB2RGB``
    (``stain_utils.py:66,172``) up to 8-bit quantization.
    """
    lab = jnp.asarray(lab, jnp.float32)
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0
    # OpenCV inverts L with the cubic branch against L>8 (equiv. Y > delta).
    y = jnp.where(L > _LAB_KAPPA * _LAB_DELTA, fy**3, L / _LAB_KAPPA)
    x = _lab_f_inv(fx)
    z = _lab_f_inv(fz)
    xyz = jnp.stack([x, y, z], axis=-1) * jnp.asarray(_WHITE)
    lin = _mm(xyz, jnp.asarray(_XYZ2RGB.T))
    srgb = _srgb_gamma_compress(lin)
    return jnp.clip(srgb, 0.0, 1.0) * 255.0


def lab_luminance(rgb):
    """L channel of CIELAB in [0,100]; the reference's tissue-mask statistic.

    ``LuminosityThresholdTissueLocator`` thresholds ``L_uint8/255``
    (``stain_utils.py:41-43``); note uint8 L = L*255/100, so that statistic is
    exactly ``L/100`` in these units.
    """
    c = jnp.asarray(rgb, jnp.float32) / 255.0
    lin = _srgb_gamma_expand(c)
    Y = _mm(lin, jnp.asarray(_RGB2XYZ.T[:, 1]))
    return jnp.where(Y > _LAB_DELTA, 116.0 * jnp.cbrt(Y) - 16.0, _LAB_KAPPA * Y)


# --------------------------------------------------------------------------
# RGB <-> optical density (Beer-Lambert)
# --------------------------------------------------------------------------


def rgb_to_od(rgb):
    """RGB [0,255] -> optical density, ``OD = max(-log(max(I,1)/255), 1e-6)``.

    Reproduces ``convert_RGB_to_OD`` (``stain_utils.py:101-112``): zero pixels
    are clamped to 1 before the log and the result is floored at 1e-6.
    """
    I = jnp.maximum(jnp.asarray(rgb, jnp.float32), 1.0)
    return jnp.maximum(-jnp.log(I / 255.0), 1e-6)


def od_to_rgb(od):
    """Optical density -> RGB float in (0,255]; ``RGB = 255*exp(-OD)``.

    Reproduces ``convert_OD_to_RGB`` (``stain_utils.py:114-124``) sans the
    uint8 cast (kept float for fusion; quantize at the pipeline edge).
    """
    od = jnp.maximum(jnp.asarray(od, jnp.float32), 1e-6)
    return 255.0 * jnp.exp(-od)


# --------------------------------------------------------------------------
# RGB <-> HED (Ruifrok-Johnston color deconvolution, skimage conventions)
# --------------------------------------------------------------------------

# Normalized stain OD vectors (rows: Haematoxylin, Eosin, DAB) as published in
# Ruifrok & Johnston 2001 and used by skimage.color.rgb_from_hed.
_RGB_FROM_HED = np.array(
    [
        [0.65, 0.70, 0.29],
        [0.07, 0.99, 0.11],
        [0.27, 0.57, 0.78],
    ],
    dtype=np.float64,
)
_RGB_FROM_HED /= np.linalg.norm(_RGB_FROM_HED, axis=1, keepdims=True)
_HED_FROM_RGB = np.linalg.inv(_RGB_FROM_HED)
_LOG_ADJUST = float(np.log(1e-6))  # skimage's log-domain scaling constant


def rgb_to_hed(rgb):
    """RGB [0,255] -> HED stain concentrations (skimage ``rgb2hed`` semantics).

    Replaces ``skimage.color.rgb2hed`` at ``augmenter.py:295``:
    ``stains = (log(max(rgb01,1e-6)) / log(1e-6)) @ hed_from_rgb``.
    """
    c = jnp.maximum(jnp.asarray(rgb, jnp.float32) / 255.0, 1e-6)
    return _mm(jnp.log(c) / _LOG_ADJUST, jnp.asarray(_HED_FROM_RGB, jnp.float32))


def hed_to_rgb(hed):
    """HED stain concentrations -> RGB float [0,255] (skimage ``hed2rgb``).

    Replaces ``skimage.color.hed2rgb`` at ``augmenter.py:319``:
    ``rgb = clip(exp(-(stains * -log(1e-6)) @ rgb_from_hed), 0, 1)``.
    """
    log_rgb = -_mm(
        jnp.asarray(hed, jnp.float32) * (-_LOG_ADJUST),
        jnp.asarray(_RGB_FROM_HED, jnp.float32),
    )
    return jnp.clip(jnp.exp(log_rgb), 0.0, 1.0) * 255.0


# --------------------------------------------------------------------------
# Grayscale (skimage luma weights)
# --------------------------------------------------------------------------

_GRAY_WEIGHTS = np.array([0.2125, 0.7154, 0.0721], dtype=np.float32)


def rgb_to_gray(rgb):
    """RGB [0,255] -> luma [0,1] with skimage's ``rgb2gray`` weights
    (``augmenter.py:397``)."""
    return _mm(jnp.asarray(rgb, jnp.float32) / 255.0, jnp.asarray(_GRAY_WEIGHTS))


# --------------------------------------------------------------------------
# RGB <-> HSD (hue-saturation-density; van der Laak et al. 2000)
# --------------------------------------------------------------------------


def rgb_to_hsd(rgb, eps: float = 1e-6):
    """RGB [0,255] -> HSD ``(cx, cy, D)``.

    The color model of the DCGMM/residual-flow pipeline (missing ``lib.
    image_transforms.RGB2HSD``; call sites ``train_img.py:415``,
    ``data_utils.py:1``): per-channel density ``D_ch = -log(I_ch/255)``,
    overall density ``D = mean(D_ch)``, chromatic coords
    ``cx = D_R/D - 1`` and ``cy = (D_G - D_B) / (sqrt(3) * D)``.
    """
    I = jnp.clip(jnp.asarray(rgb, jnp.float32), 1.0, 254.0) / 255.0
    od = -jnp.log(I)
    D = jnp.maximum(jnp.mean(od, axis=-1), eps)
    cx = od[..., 0] / D - 1.0
    cy = (od[..., 1] - od[..., 2]) / (jnp.sqrt(3.0) * D)
    return jnp.stack([cx, cy, D], axis=-1)


def hsd_to_rgb(hsd):
    """HSD ``(cx, cy, D)`` -> RGB float [0,255]; inverse of :func:`rgb_to_hsd`
    (missing ``lib.image_transforms.HSD2RGB_Numpy``; call sites
    ``train_img_horo.py:735,848``)."""
    hsd = jnp.asarray(hsd, jnp.float32)
    cx, cy, D = hsd[..., 0], hsd[..., 1], hsd[..., 2]
    od_r = D * (cx + 1.0)
    od_g = 0.5 * D * (2.0 - cx + jnp.sqrt(3.0) * cy)
    od_b = 0.5 * D * (2.0 - cx - jnp.sqrt(3.0) * cy)
    od = jnp.stack([od_r, od_g, od_b], axis=-1)
    return jnp.clip(jnp.exp(-od), 0.0, 1.0) * 255.0


# --------------------------------------------------------------------------
# uint8 edges
# --------------------------------------------------------------------------


def to_uint8(x):
    """Clip to [0,255] and cast — the pipeline-edge quantization."""
    return jnp.clip(x, 0.0, 255.0).astype(jnp.uint8)
