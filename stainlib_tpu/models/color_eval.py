"""Color-normalization deployment: template transfer + NMI metrics.

JAX counterparts of the missing ``lib.image_transforms`` deployment
path and the metric block of ``train_img_horo.py:658-930``:

* per-class HSD color statistics under GMM responsibilities (the template
  accumulation of ``train_img_horo.py:676-727``, allreduced across workers);
* ``image_dist_transform`` (``:815,1015``): recolor a test image by mapping
  each tissue class's HSD distribution onto the template's (mu, sigma),
  weighted by the class responsibilities;
* NMI (normalized median intensity) = median/95th-percentile of the mean-RGB
  of each tissue class (``:817-840``), with SD and CV aggregated across
  images (``:865-885``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from stainlib_tpu.ops.colorspace import hsd_to_rgb, to_uint8
from stainlib_tpu.ops.percentile import masked_percentile


def class_color_stats(hsd, gamma, eps: float = 1e-6):
    """Responsibility-weighted per-class mean/std of HSD channels.

    ``hsd``: (B, H, W, 3); ``gamma``: (B, H, W, K). Returns mu, sigma of
    shape (K, 3) — the running template statistics the reference accumulates
    and ``hvd.allreduce``s (``train_img_horo.py:703-727,742-744``).
    """
    w = jnp.asarray(gamma, jnp.float32)
    x = jnp.asarray(hsd, jnp.float32)
    tot = jnp.sum(w, axis=(0, 1, 2)) + eps  # (K,)
    mu = jnp.einsum("bhwk,bhwc->kc", w, x) / tot[:, None]
    sq = jnp.einsum("bhwk,bhwc->kc", w, x * x) / tot[:, None]
    sigma = jnp.sqrt(jnp.maximum(sq - mu * mu, eps))
    return mu, sigma


def image_dist_transform(hsd, gamma, mu_src, sigma_src, mu_tmpl, sigma_tmpl,
                         perm=None):
    """Per-class distribution transfer in HSD, responsibility-weighted.

    out = sum_k gamma_k * ((x - mu_src_k) / sigma_src_k * sigma_tmpl_k
                            + mu_tmpl_k)

    Returns uint8 RGB (the deployment output at ``train_img_horo.py:815``).

    ``perm`` (optional, (K,) int): source class k takes the TEMPLATE class
    ``perm[k]``'s statistics instead of class k's. The reference maps k -> k
    unconditionally (``train_img_horo.py:815,1015``), which breaks when the
    GMM's class labelling permutes on out-of-distribution centers (measured
    by ``scripts/seg_transfer_demo.py``); pass the output of
    :func:`match_classes_by_usage` to deploy permutation-robustly.
    """
    if perm is not None:
        mu_tmpl = jnp.asarray(mu_tmpl)[perm]
        sigma_tmpl = jnp.asarray(sigma_tmpl)[perm]
    x = jnp.asarray(hsd, jnp.float32)[..., None, :]  # (B,H,W,1,3)
    norm = (x - mu_src) / jnp.maximum(sigma_src, 1e-6)
    mapped = norm * sigma_tmpl + mu_tmpl  # (B,H,W,K,3)
    out = jnp.einsum("bhwk,bhwkc->bhwc", jnp.asarray(gamma, jnp.float32), mapped)
    return to_uint8(hsd_to_rgb(out))


def class_color_cov(hsd, gamma, eps: float = 1e-6):
    """Responsibility-weighted per-class mean and FULL covariance of the
    HSD channels: (B,H,W,3), (B,H,W,K) -> mu (K,3), cov (K,3,3).

    EXTENSION over the reference's (mu, sigma) accumulation
    (``train_img_horo.py:703-727`` keeps per-channel seconds moments only):
    the cross-channel terms carry the chroma ORIENTATION of each tissue
    class, which the diagonal transfer cannot move (measured by
    ``scripts/seg_transfer_demo.py`` on hue-rotated centers).
    """
    w = jnp.asarray(gamma, jnp.float32)
    x = jnp.asarray(hsd, jnp.float32)
    tot = jnp.sum(w, axis=(0, 1, 2)) + eps  # (K,)
    mu = jnp.einsum("bhwk,bhwc->kc", w, x) / tot[:, None]
    xx = jnp.einsum("bhwk,bhwc,bhwd->kcd", w, x, x) / tot[:, None, None]
    cov = xx - mu[:, :, None] * mu[:, None, :]
    cov = cov + eps * jnp.eye(3)
    return mu, cov


def _spd_power(M, p, eps: float = 1e-8):
    """Symmetric power M^p of a batch (K,3,3) of SPD matrices via eigh."""
    w, V = jnp.linalg.eigh(M)
    w = jnp.maximum(w, eps) ** p
    return jnp.einsum("kij,kj,klj->kil", V, w, V)


def monge_maps(cov_src, cov_tmpl):
    """Per-class Gaussian optimal-transport (Monge) matrices (K,3,3):

    A_k = S_k^{-1/2} (S_k^{1/2} T_k S_k^{1/2})^{1/2} S_k^{-1/2}

    — the unique SPD linear map with A S A^T = T, i.e. the transfer that
    matches the template's full covariance (rotation included), reducing to
    ``sigma_tmpl / sigma_src`` exactly when both covariances are diagonal.
    """
    s_half = _spd_power(cov_src, 0.5)
    s_ihalf = _spd_power(cov_src, -0.5)
    inner = jnp.einsum("kij,kjl,klm->kim", s_half, cov_tmpl, s_half)
    return jnp.einsum("kij,kjl,klm->kim", s_ihalf, _spd_power(inner, 0.5),
                      s_ihalf)


def image_dist_transform_full(hsd, gamma, mu_src, cov_src, mu_tmpl, cov_tmpl,
                              perm=None):
    """Full-covariance per-class transfer (EXTENSION; see
    :func:`class_color_cov`):

    out = sum_k gamma_k * (A_k (x - mu_src_k) + mu_tmpl_k)

    with A_k the per-class Monge map. Same contract as
    :func:`image_dist_transform` (uint8 RGB out); ``perm`` permutes the
    template statistics as there."""
    if perm is not None:
        mu_tmpl = jnp.asarray(mu_tmpl)[perm]
        cov_tmpl = jnp.asarray(cov_tmpl)[perm]
    A = monge_maps(jnp.asarray(cov_src, jnp.float32),
                   jnp.asarray(cov_tmpl, jnp.float32))
    x = jnp.asarray(hsd, jnp.float32)[..., None, :] - mu_src  # (B,H,W,K,3)
    mapped = jnp.einsum("bhwkc,kdc->bhwkd", x, A,
                        precision=jax.lax.Precision.HIGHEST) + mu_tmpl
    out = jnp.einsum("bhwk,bhwkc->bhwc", jnp.asarray(gamma, jnp.float32),
                     mapped)
    return to_uint8(hsd_to_rgb(out))


def class_channel_quantiles(hsd, gamma, n_points: int = 33,
                            prior_weight: float = 256.0, eps: float = 1e-6):
    """Responsibility-weighted per-class per-channel quantile curves.

    Returns ``(q, mass)``: ``q`` of shape (K, 3, P) — the weighted quantile
    function of each class/channel sampled at P evenly spaced probabilities
    — and ``mass`` (K,), the total responsibility behind each curve.

    EXTENSION beyond the reference's two-moment accumulation
    (``train_img_horo.py:703-727``): the full quantile curve captures the
    NON-AFFINE within-class shifts measured on the synthetic cohort's hard
    centers (``scripts/seg_transfer_demo.py`` — Q-Q affine residual up to 0.91 of the
    template spread, which bounds every affine transfer).

    Classes with little mass are shrunk toward the GLOBAL (class-agnostic)
    curve with weight ``mass / (mass + prior_weight)`` — this also covers
    classes the template never uses (measured: shifted centers route ~9% of
    pixels through a template-empty class, whose (mu, sigma) are
    unsupported noise under the reference transfer).
    """
    x = jnp.asarray(hsd, jnp.float32).reshape(-1, 3)           # (N, 3)
    w = jnp.asarray(gamma, jnp.float32).reshape(-1, gamma.shape[-1])
    ps = jnp.linspace(0.0, 1.0, n_points)

    def per_channel(xc, wk):
        """xc (N,), wk (N, K') -> (K', P) weighted quantiles."""
        order = jnp.argsort(xc)
        xs = xc[order]
        ws = wk[order]
        cw = jnp.cumsum(ws, axis=0)
        tot = cw[-1]                                            # (K',)
        cwm = (cw - 0.5 * ws) / jnp.maximum(tot, eps)           # (N, K')
        return jax.vmap(lambda c: jnp.interp(ps, c, xs),
                        in_axes=1)(cwm)

    q_cls = jax.vmap(per_channel, in_axes=(1, None),
                     out_axes=1)(x, w)                          # (K, 3, P)
    ones = jnp.ones((x.shape[0], 1), jnp.float32)
    q_glob = jax.vmap(per_channel, in_axes=(1, None),
                      out_axes=1)(x, ones)[0]                   # (3, P)
    mass = jnp.sum(w, axis=0)                                   # (K,)
    lam = (mass / (mass + prior_weight))[:, None, None]
    return lam * q_cls + (1.0 - lam) * q_glob, mass


def image_dist_transform_quantile(hsd, gamma, q_src, q_tmpl, perm=None,
                                  space: str = "hsd"):
    """Per-class monotone QUANTILE-MATCHING transfer (EXTENSION; see
    :func:`class_channel_quantiles`):

    out = sum_k gamma_k * interp(x, q_src_k, q_tmpl_k)   (per channel)

    — maps each class's full distribution onto the template's instead of
    only its first two moments, closing the measured non-affine residual.
    Same contract as :func:`image_dist_transform` (uint8 RGB out).

    ``space`` selects the channels being matched: ``"hsd"`` (default — the
    reference's deployment color model) matches the HSD channels and
    converts back; ``"rgb"`` expects ``hsd``/the curves to already BE float
    RGB in [0, 255] and matches the RGB channels directly. Acquisition-layer
    distortions (scanner tone curves) are monotone PER RGB CHANNEL
    (``data/synthetic.py::_filmic``), which is non-separable after the HSD
    mix — RGB-space matching inverts them exactly; measured on the
    acquisition cohort by ``scripts/seg_transfer_demo.py``."""
    if space not in ("hsd", "rgb"):
        raise ValueError(f"space must be 'hsd' or 'rgb', got {space!r}")
    if perm is not None:
        q_tmpl = jnp.asarray(q_tmpl)[perm]
    x = jnp.asarray(hsd, jnp.float32)                           # (B,H,W,3)
    g = jnp.asarray(gamma, jnp.float32)

    def map_class(qs_k, qt_k):
        """(3,P),(3,P) -> (B,H,W,3) monotone per-channel map of x."""
        return jax.vmap(
            lambda qs, qt, xc: jnp.interp(xc, qs, qt),
            in_axes=(0, 0, -1), out_axes=-1)(qs_k, qt_k, x)

    # Gamma-weighted sum accumulated class by class: interp's gather blocks
    # XLA from fusing a stacked (K,B,H,W,3) vmap output, which at deploy
    # batch sizes (64 x 256^2, K=8 -> ~1.6 GB) pressures HBM on the slide
    # path; the scan keeps one (B,H,W,3) map live per step.
    def body(acc, xs):
        qs_k, qt_k, g_k = xs
        return acc + g_k[..., None] * map_class(qs_k, qt_k), None

    out, _ = jax.lax.scan(
        body, jnp.zeros_like(x),
        (jnp.asarray(q_src, jnp.float32), jnp.asarray(q_tmpl, jnp.float32),
         jnp.moveaxis(g, -1, 0)))
    return to_uint8(out if space == "rgb" else hsd_to_rgb(out))


def image_dist_transform_full_quantile(hsd, gamma, mu_src, cov_src,
                                       mu_tmpl, cov_tmpl, q_tmpl,
                                       n_points: int = 33,
                                       prior_weight: float = 256.0,
                                       perm=None, space: str = "hsd"):
    """Composite per-class transfer (EXTENSION): Monge rotation first, then
    per-channel quantile matching of the rotated values onto the template's
    curves — fixes both failure modes measured by ``scripts/seg_transfer_demo.py`` (chroma
    rotation, which per-channel maps cannot produce, and non-affine
    marginal shifts, which affine maps cannot close). Same contract as
    :func:`image_dist_transform`.

    ``space`` as in :func:`image_dist_transform_quantile`: with ``"rgb"``,
    ``hsd`` and every statistic are float RGB in [0, 255] and no HSD->RGB
    conversion is applied on output. The RGB composite is the natural fit
    for acquisition-style variation (``scripts/seg_transfer_demo.py``): per-center stain
    MIXING is linear in OD/RGB (the Monge map absorbs it per class) while
    scanner tone curves are per-RGB-channel monotone (the quantile
    correction inverts them)."""
    if space not in ("hsd", "rgb"):
        raise ValueError(f"space must be 'hsd' or 'rgb', got {space!r}")
    if perm is not None:
        mu_tmpl = jnp.asarray(mu_tmpl)[perm]
        cov_tmpl = jnp.asarray(cov_tmpl)[perm]
        q_tmpl = jnp.asarray(q_tmpl)[perm]
    A = monge_maps(jnp.asarray(cov_src, jnp.float32),
                   jnp.asarray(cov_tmpl, jnp.float32))
    x = jnp.asarray(hsd, jnp.float32)                          # (B,H,W,3)
    g = jnp.asarray(gamma, jnp.float32)
    ps = jnp.linspace(0.0, 1.0, n_points)

    def class_curve(y_k, w_k):
        """Weighted per-channel quantiles of the class-k mapped values:
        (N,3),(N,) -> (3,P), shrunk toward equal-weight curves of the same
        values when the class mass is small."""
        def chan(yc):
            order = jnp.argsort(yc)
            ys = yc[order]
            ws = w_k[order]
            cw = jnp.cumsum(ws)
            tot = cw[-1]
            cwm = (cw - 0.5 * ws) / jnp.maximum(tot, 1e-6)
            # Equal-weight fallback curve for near-empty classes.
            n = ys.shape[0]
            cwe = (jnp.arange(n, dtype=jnp.float32) + 0.5) / n
            lam = tot / (tot + prior_weight)
            return (lam * jnp.interp(ps, cwm, ys)
                    + (1.0 - lam) * jnp.interp(ps, cwe, ys))
        return jax.vmap(chan, in_axes=1)(y_k)

    def map_class(y_k, qs_k, qt_k):
        return jax.vmap(
            lambda qs, qt, yc: jnp.interp(yc, qs, qt),
            in_axes=(0, 0, -1), out_axes=-1)(qs_k, qt_k, y_k)

    # One class per scan step: rotate, estimate the rotated curve, match
    # it onto the template's, accumulate the gamma-weighted map. Keeps the
    # peak intermediate at (B,H,W,3) instead of the (B,H,W,K,3) Monge
    # stack + (K,B,H,W,3) vmap output of a vmapped version.
    def body(acc, xs):
        mu_s_k, A_k, mu_t_k, qt_k, g_k = xs
        y_k = jnp.einsum("bhwc,dc->bhwd", x - mu_s_k, A_k,
                         precision=jax.lax.Precision.HIGHEST) + mu_t_k
        q_y_k = class_curve(y_k.reshape(-1, 3), g_k.reshape(-1))
        return acc + g_k[..., None] * map_class(y_k, q_y_k, qt_k), None

    out, _ = jax.lax.scan(
        body, jnp.zeros_like(x),
        (jnp.asarray(mu_src, jnp.float32), A,
         jnp.asarray(mu_tmpl, jnp.float32),
         jnp.asarray(q_tmpl, jnp.float32), jnp.moveaxis(g, -1, 0)))
    return to_uint8(out if space == "rgb" else hsd_to_rgb(out))


def class_usage(gamma):
    """Mean responsibility share per class: (..., K) -> (K,), sums to 1.
    The histogram whose permutation across centers is the measured
    seg-transfer failure mechanism (``scripts/seg_transfer_demo.py``)."""
    g = jnp.asarray(gamma, jnp.float32)
    u = jnp.mean(g.reshape(-1, g.shape[-1]), axis=0)
    return u / jnp.maximum(jnp.sum(u), 1e-12)


def match_classes_by_usage(usage_src, usage_tmpl):
    """Rank-match source GMM classes to template classes by usage share.

    Returns ``perm`` (K,) int32 with ``perm[k]`` = the template class whose
    usage RANK equals source class k's rank (dominant source tissue maps to
    dominant template tissue, and so on). Identity whenever the two usage
    orderings agree — i.e. a no-op exactly when the reference's k -> k
    mapping is already class-correct. jit-friendly (argsort + scatter).
    """
    order_src = jnp.argsort(-jnp.asarray(usage_src))   # ranks -> src class
    order_tmpl = jnp.argsort(-jnp.asarray(usage_tmpl))  # ranks -> tmpl class
    perm = jnp.zeros(order_src.shape[0], jnp.int32)
    return perm.at[order_src].set(order_tmpl.astype(jnp.int32))


def nmi(rgb, mask):
    """Normalized median intensity of the masked pixels of one image:
    median(mean-RGB) / 95th-percentile(mean-RGB). A whole-mask variant
    (one value per image over the tissue mask) used for the synthetic
    before/after comparisons; the reference's exact per-tissue-class
    statistic is :func:`nmi_per_class` (``train_img_horo.py:817-840``).
    ``rgb``: (H, W, 3) in [0,255]; ``mask``: (H, W) bool."""
    u = jnp.mean(jnp.asarray(rgb, jnp.float32), axis=-1).reshape(-1)
    m = jnp.asarray(mask).reshape(-1)
    med = masked_percentile(u, m, 50.0)
    p95 = masked_percentile(u, m, 95.0)
    return med / jnp.maximum(p95, 1e-6)


def nmi_sd_cv(nmi_values):
    """SD and CV of an NMI sample (``train_img_horo.py:865-885``); the
    headline NMI numbers. Host-side numpy over gathered values."""
    v = np.asarray(nmi_values, np.float64)
    sd = float(v.std(ddof=0))
    cv = float(sd / max(v.mean(), 1e-12))
    return sd, cv


def nmi_per_class(rgb, gamma):
    """The reference's exact NMI statistic (``train_img_horo.py:817-840``):
    per image and per GMM tissue class, median / 95th-percentile of the
    channel-mean intensity over the class's argmax-membership mask
    (``ClsLbl = argmax(pi)``).

    ``rgb``: (B, H, W, 3) in [0,255] (the recolored deployment output);
    ``gamma``: (B, H, W, K) responsibilities. Returns (B, K) float64 with
    NaN where a class has no pixels in an image (the reference skips the
    metric for absent classes). Host-side numpy — this is the eval path.
    """
    rgb = np.asarray(rgb, np.float64)
    g = np.asarray(gamma)
    cls = np.argmax(g, axis=-1)  # (B, H, W)
    B, K = g.shape[0], g.shape[-1]
    mean_rgb = rgb.mean(axis=-1)
    out = np.full((B, K), np.nan)
    for i in range(B):
        for k in range(K):
            vals = mean_rgb[i][cls[i] == k]
            if vals.size:
                p95 = np.percentile(vals, 95)
                out[i, k] = np.median(vals) / max(p95, 1e-6)
    return out


def class_nmi_sd_cv(nmi_bk):
    """Aggregate :func:`nmi_per_class` values the reference's way
    (``train_img_horo.py:865-898``): per class, SD (Bessel-corrected, as
    ``torch.std``) and CV over all images where the class is present; the
    headline numbers are the AVERAGE SD and CV across present classes.
    Returns (avg_sd, avg_cv, per_class) with per_class a list of
    (class_index, sd, cv)."""
    v = np.asarray(nmi_bk, np.float64)
    per_class = []
    for k in range(v.shape[1]):
        col = v[:, k]
        col = col[~np.isnan(col)]
        if col.size < 2:
            continue
        sd = float(col.std(ddof=1))
        cv = float(sd / max(col.mean(), 1e-12))
        per_class.append((k, sd, cv))
    if not per_class:
        return float("nan"), float("nan"), per_class
    avg_sd = float(np.mean([s for _, s, _ in per_class]))
    avg_cv = float(np.mean([c for _, _, c in per_class]))
    return avg_sd, avg_cv, per_class
