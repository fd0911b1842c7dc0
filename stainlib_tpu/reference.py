"""Plain numpy reference of the stain pipeline, independent of the JAX code.

A straightforward float64 restatement of the reference library's formulas
(SURVEY.md section 3.1) that shares no code with the device path: Macenko
and Vahadane estimation, the closed-form non-negative lasso, the extractive
transform, Reinhard LAB transfer, HED jitter and the stain augmenter's
perturbation. ``bench.py``, ``chip_smoke.py`` and the tests compare the
device output against it with :func:`delta_e` (mean CIE76). Only numpy is
needed, so it runs on any host.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Synthetic H&E tiles (self-contained; no dataset dependency)
# --------------------------------------------------------------------------

_HE = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
_HE = _HE / np.linalg.norm(_HE, axis=1, keepdims=True)


def make_tiles(n, h=256, w=256, seed=0):
    """``n`` synthetic (h, w, 3) uint8 H&E tiles with a white top band
    (background for the tissue mask), deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        c_h = np.clip(0.8 + 0.6 * np.sin(yy / 9.0 + i) * np.cos(xx / 7.0), 0, None)
        c_e = np.clip(0.6 + 0.4 * np.cos(yy / 11.0) * np.sin(xx / 5.0 + i), 0, None)
        C = np.stack([c_h, c_e], -1) * (0.9 + 0.2 * rng.random((h, w, 2)))
        img = 255.0 * np.exp(-(C @ _HE))
        img[: h // 5] = 255 - rng.integers(0, 3, (h // 5, w, 3))
        out[i] = np.clip(img, 0, 255).astype(np.uint8)
    return out


# --------------------------------------------------------------------------
# Colour spaces (OpenCV constants, D65 white point)
# --------------------------------------------------------------------------

_RGB2XYZ = np.array([[0.412453, 0.357580, 0.180423],
                     [0.212671, 0.715160, 0.072169],
                     [0.019334, 0.119193, 0.950227]])
_WHITE = np.array([0.950456, 1.0, 1.088754])


def _lab_f(t):
    return np.where(t > 0.008856, np.cbrt(t), 7.787 * t + 16.0 / 116.0)


def rgb_to_lab(I):
    """sRGB [0,255] -> CIELAB (L in [0,100])."""
    c = np.asarray(I, np.float64) / 255.0
    lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    xyz = lin @ _RGB2XYZ.T / _WHITE
    y = xyz[..., 1]
    L = np.where(y > 0.008856, 116.0 * np.cbrt(y) - 16.0, 903.3 * y)
    f = _lab_f(xyz)
    return np.stack([L, 500.0 * (f[..., 0] - f[..., 1]),
                     200.0 * (f[..., 1] - f[..., 2])], -1)


def lab_to_rgb(lab):
    """CIELAB -> sRGB float [0,255], clipped."""
    L, a, b = lab[..., 0], lab[..., 1], lab[..., 2]
    fy = (L + 16.0) / 116.0
    fx, fz = fy + a / 500.0, fy - b / 200.0

    def f_inv(ft):
        t3 = ft ** 3
        return np.where(t3 > 0.008856, t3, (ft - 16.0 / 116.0) / 7.787)

    y = np.where(L > 903.3 * 0.008856, fy ** 3, L / 903.3)
    xyz = np.stack([f_inv(fx), y, f_inv(fz)], -1) * _WHITE
    lin = np.maximum(xyz @ np.linalg.inv(_RGB2XYZ).T, 0.0)
    srgb = np.where(lin <= 0.0031308, lin * 12.92,
                    1.055 * lin ** (1.0 / 2.4) - 0.055)
    return np.clip(srgb, 0.0, 1.0) * 255.0


def delta_e(a, b):
    """Mean CIE76 delta-E between two uint8 RGB images or batches."""
    return float(np.sqrt(((rgb_to_lab(a) - rgb_to_lab(b)) ** 2).sum(-1)).mean())


# --------------------------------------------------------------------------
# Extractive normalization (normalizer.py:16-50)
# --------------------------------------------------------------------------


def od(I):
    """``convert_RGB_to_OD`` (stain_utils.py:101-112)."""
    return np.maximum(-np.log(np.maximum(np.asarray(I, np.float64), 1.0) / 255.0),
                      1e-6)


def tissue_mask(I, luminosity_threshold=0.8):
    """LAB-luminosity tissue mask (stain_utils.py:29-48)."""
    return rgb_to_lab(I)[..., 0] / 100.0 < luminosity_threshold


def macenko(I):
    """Macenko stain matrix (macenko_stain_extractor.py:7-44), H first."""
    mask = tissue_mask(I).reshape(-1)
    o = od(I).reshape(-1, 3)[mask]
    _, V = np.linalg.eigh(np.cov(o, rowvar=False))
    V = V[:, [2, 1]]
    V[:, 0] *= 1 if V[0, 0] >= 0 else -1
    V[:, 1] *= 1 if V[0, 1] >= 0 else -1
    proj = o @ V
    phi = np.arctan2(proj[:, 1], proj[:, 0])
    lo, hi = np.percentile(phi, 1), np.percentile(phi, 99)
    v1 = V @ np.array([np.cos(lo), np.sin(lo)])
    v2 = V @ np.array([np.cos(hi), np.sin(hi)])
    HE = np.array([v1, v2]) if v1[0] > v2[0] else np.array([v2, v1])
    return HE / np.linalg.norm(HE, axis=1, keepdims=True)


def lasso(o, M, lam=0.01):
    """Closed-form non-negative lasso of (N, 3) OD pixels on a 2x3 matrix."""
    G = M @ M.T
    b = o @ M.T - lam
    det = G[0, 0] * G[1, 1] - G[0, 1] ** 2
    c1f = (G[1, 1] * b[:, 0] - G[0, 1] * b[:, 1]) / det
    c2f = (G[0, 0] * b[:, 1] - G[0, 1] * b[:, 0]) / det
    okf = (c1f >= 0) & (c2f >= 0)
    c1o = np.maximum(b[:, 0], 0) / G[0, 0]
    ok1 = (b[:, 0] >= 0) & (G[0, 1] * c1o - b[:, 1] >= 0)
    c2o = np.maximum(b[:, 1], 0) / G[1, 1]
    ok2 = (b[:, 1] >= 0) & (G[0, 1] * c2o - b[:, 0] >= 0)
    c1 = np.where(okf, c1f, np.where(ok1, c1o, 0.0))
    c2 = np.where(okf, c2f, np.where(~ok1 & ok2, c2o, 0.0))
    return np.stack([c1, c2], -1)


def vahadane(I, lam=0.1, iters=12):
    """Vahadane stain matrix: dictionary learning by alternating the exact
    lasso with two block-coordinate sweeps over the stain rows (the role of
    SPAMS ``trainDL``, vahadane_stain_extractor.py:19-43), Macenko warm
    start, fixed iteration count."""
    mask = tissue_mask(I).reshape(-1)
    o = od(I).reshape(-1, 3)
    m = mask.astype(np.float64)
    D = macenko(I)
    if not np.isfinite(D).all():
        D = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
        D /= np.linalg.norm(D, axis=1, keepdims=True)
    for _ in range(iters):
        A = lasso(o, D, lam)
        Aw = A * m[:, None]
        C = Aw.T @ A
        B = Aw.T @ o
        for _s in range(2):
            for j in range(2):
                cjj = max(C[j, j], 1e-8)
                u = np.maximum(D[j] + (B[j] - C[j] @ D) / cjj, 0)
                if u.sum() > 0:
                    D[j] = u / max(np.linalg.norm(u), 1.0)
    if D[0, 0] < D[1, 0]:
        D = D[::-1]
    return D / np.linalg.norm(D, axis=1, keepdims=True)


_EXTRACTORS = {"macenko": macenko, "vahadane": vahadane}


def extractive_fit(target, method="macenko"):
    """(stain matrix, 99th-percentile maxC) of a target (normalizer.py:27-37)."""
    M = _EXTRACTORS[method](target)
    C = lasso(od(target).reshape(-1, 3), M)
    return M, np.percentile(C, 99, axis=0)


def cpu_transform(I, M_tgt, maxc_tgt, method="macenko"):
    """Normalize one image toward a fitted target (normalizer.py:39-50)."""
    M_src = _EXTRACTORS[method](I)
    C = lasso(od(I).reshape(-1, 3), M_src)
    maxc_src = np.percentile(C, 99, axis=0)
    C = C * (maxc_tgt / maxc_src)
    out = 255.0 * np.exp(-(C @ M_tgt))
    return np.clip(out.reshape(I.shape), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# Reinhard (normalizer.py:54-94), through the reference's uint8 LAB image
# --------------------------------------------------------------------------

_LAB_PACK = np.array([2.55, 1.0, 1.0])
_LAB_OFF = np.array([0.0, 128.0, 128.0])


def _reinhard_lab(I):
    """Brightness-standardize (stain_utils.py:188-194) and take the uint8
    LAB image the reference works on (stain_utils.py:146-158)."""
    I = np.asarray(I, np.float64)
    I = np.floor(np.clip(I * 255.0 / np.percentile(I, 90), 0, 255))
    packed = np.clip(np.round(rgb_to_lab(I) * _LAB_PACK + _LAB_OFF), 0, 255)
    return (packed - _LAB_OFF) / _LAB_PACK


def reinhard_fit(target):
    """Target LAB mean / population std (normalizer.py:64-68)."""
    lab = _reinhard_lab(target)
    return lab.mean((0, 1)), lab.std((0, 1))


def reinhard_transform(I, t_means, t_stds):
    """Reinhard transfer of one image, no background mask (normalizer.py:70-94)."""
    lab = _reinhard_lab(I)
    out = (lab - lab.mean((0, 1))) * (t_stds / lab.std((0, 1))) + t_means
    packed = np.floor(np.clip(out * _LAB_PACK + _LAB_OFF, 0, 255))
    rgb = lab_to_rgb((packed - _LAB_OFF) / _LAB_PACK)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


# --------------------------------------------------------------------------
# Augmentation (augmenter.py:276-326, 428-448)
# --------------------------------------------------------------------------

_RGB_FROM_HED = np.array([[0.65, 0.70, 0.29],
                          [0.07, 0.99, 0.11],
                          [0.27, 0.57, 0.78]])
_RGB_FROM_HED = _RGB_FROM_HED / np.linalg.norm(_RGB_FROM_HED, axis=1,
                                               keepdims=True)
_LOG_ADJUST = np.log(1e-6)


def hed_apply(I, sigmas, biases, cutoff_range=(0.0, 1.0)):
    """skimage rgb2hed -> ``hed * (1 + sigma) + bias`` -> hed2rgb, with the
    patch-mean cutoff gate."""
    x = np.asarray(I, np.float64)
    if not cutoff_range[0] <= x.mean() / 255.0 <= cutoff_range[1]:
        return np.asarray(I, np.uint8)
    hed = (np.log(np.maximum(x / 255.0, 1e-6)) / _LOG_ADJUST
           @ np.linalg.inv(_RGB_FROM_HED))
    hed = hed * (1.0 + np.asarray(sigmas)) + np.asarray(biases)
    rgb = np.clip(np.exp(-(hed * -_LOG_ADJUST) @ _RGB_FROM_HED), 0, 1) * 255.0
    return np.clip(rgb, 0, 255).astype(np.uint8)


def stain_augment(I, alpha, beta, method="macenko"):
    """One ``StainAugmentor.pop`` draw with given per-stain alpha/beta:
    tissue concentrations become ``C * alpha + beta``."""
    M = _EXTRACTORS[method](I)
    C = lasso(od(I).reshape(-1, 3), M)
    mask = tissue_mask(I).reshape(-1, 1)
    C = np.where(mask, C * alpha + beta, C)
    out = 255.0 * np.exp(-(C @ M))
    return np.clip(out.reshape(I.shape), 0, 255).astype(np.uint8)
