"""Validation / deployment orchestration for the flow color normalizer.

Parity with ``train_img_horo.py:658-930`` (``validate``):

  1. TEMPLATE pass over the template loader: encode, accumulate
     responsibility-weighted per-class HSD statistics as running sums;
  2. allreduce the template statistics across data-parallel workers
     (``hvd.allreduce``/broadcast at ``:742-748``) — here a ``psum`` when a
     mesh is active, or a plain sum of per-shard sums;
  3. DEPLOY pass over the test loader: encode each batch, recolor via
     :func:`stainlib_tpu.models.color_eval.image_dist_transform`, compute the
     per-image NMI;
  4. gather NMI vectors (``hvd.allgather`` at ``:877``) and report SD / CV
     (``:865-885``) plus a CSV dump (``:899-906``).

And ``visualize`` (``:933-1074``) / ``savegamma`` (``:632-656``): PNG dumps
of template/test/converted images and class-membership maps.
"""

from __future__ import annotations

import csv
import functools
import os
from typing import Any, Iterable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from stainlib_tpu.models import color_eval
from stainlib_tpu.models.train_flow import FlowConfig, encode
from stainlib_tpu.ops.colorspace import hsd_to_rgb, to_uint8
from stainlib_tpu.ops.tissue import tissue_mask
from stainlib_tpu.utils.meters import Throughput


class TemplateSums(NamedTuple):
    """Sum-decomposable template-statistic state (``train_img_horo.py:
    676-727``): additive across batches AND across data-parallel shards —
    exactly what the reference allreduces (``hvd.allreduce`` of the
    stat sums, ``:742-748``; here :func:`collectives.psum_stats`).
    ``xxT``/``wq`` are the r4 extension accumulators (full covariance /
    quantile barycenter) and are ``None`` unless requested."""

    w: Any            # (K,)   responsibility mass
    x: Any            # (K,3)  gamma-weighted HSD sum
    xx: Any           # (K,3)  gamma-weighted HSD^2 sum
    xxT: Any = None   # (K,3,3) gamma-weighted outer-product sum
    wq: Any = None    # (K,3,P) mass-weighted quantile-curve sum


class TemplateStats(NamedTuple):
    """Finalized template statistics. ``usage`` is always present (free —
    it is ``w`` normalized); ``cov``/``quantiles`` are ``None`` unless the
    matching accumulator was requested. Named fields replace a
    flag-dependent positional tuple (where ``stats[3]`` meant
    covariances in one caller and quantile curves in another)."""

    mu: Any                 # (K,3)
    sigma: Any              # (K,3)
    usage: Any = None       # (K,)
    cov: Any = None         # (K,3,3)
    quantiles: Any = None   # (K,3,P)


def _batch_sums(flow, gmm, cfg, params, spectral, hsd, key,
                with_cov: bool, with_quantiles: bool,
                quantile_space: str = "hsd",
                moment_space: str = "hsd") -> TemplateSums:
    """One batch's contribution to the template sums (pure; jit/shard_map
    safe — gamma is key-independent, the key only drives the stochastic
    logdet estimator inside ``encode``). ``quantile_space`` selects the
    channels the quantile curves summarize: the HSD input itself, or its
    float-RGB rendering (see
    :func:`color_eval.image_dist_transform_quantile`); ``moment_space``
    does the same for the moment sums (x/xx/xxT) — 'rgb' feeds the RGB
    composite transfer (``scripts/seg_transfer_demo.py``)."""
    _, _, gamma = encode(flow, gmm, params, spectral, cfg, hsd, key)
    xm = hsd if moment_space == "hsd" else hsd_to_rgb(hsd)
    w = jnp.sum(gamma, axis=(0, 1, 2))  # (K,)
    x = jnp.einsum("bhwk,bhwc->kc", gamma, xm)
    xx = jnp.einsum("bhwk,bhwc->kc", gamma, xm * xm)
    xxT = (jnp.einsum("bhwk,bhwc,bhwd->kcd", gamma, xm, xm)
           if with_cov else None)
    wq = None
    if with_quantiles:
        xq = hsd if quantile_space == "hsd" else hsd_to_rgb(hsd)
        q_b, m_b = color_eval.class_channel_quantiles(xq, gamma)
        wq = m_b[:, None, None] * q_b
    return TemplateSums(w, x, xx, xxT, wq)


def accumulate_template_sums(flow, gmm, cfg: FlowConfig, params, spectral,
                             template_batches: Iterable, key,
                             with_cov: bool = False,
                             with_quantiles: bool = False,
                             quantile_space: str = "hsd",
                             moment_space: str = "hsd") -> TemplateSums:
    """Template-sum accumulation over all template batches — the running
    sums of ``train_img_horo.py:676-727`` before their allreduce. Under
    multi-host SPMD, psum the result over the 'data' axis
    (:func:`stainlib_tpu.parallel.collectives.psum_stats`) before
    :func:`finalize_stats`, or use :func:`template_sums_sharded`."""
    fn = jax.jit(functools.partial(
        _batch_sums, flow, gmm, cfg, params, spectral,
        with_cov=with_cov, with_quantiles=with_quantiles,
        quantile_space=quantile_space, moment_space=moment_space))
    sums = None
    for hsd in template_batches:
        key, sub = jax.random.split(key)
        s = fn(jnp.asarray(hsd, jnp.float32), sub)
        sums = s if sums is None else jax.tree.map(jnp.add, sums, s)
    return sums


def template_sums_sharded(flow, gmm, cfg: FlowConfig, params, spectral,
                          hsd, key, mesh, axis_name: str = "data",
                          with_cov: bool = False,
                          with_quantiles: bool = False,
                          quantile_space: str = "hsd",
                          moment_space: str = "hsd") -> TemplateSums:
    """One global template batch SHARDED over ``mesh[axis_name]``: each
    shard encodes its local tiles and computes local sums, then the sums
    are allreduced in-program (``psum_stats`` — the ``hvd.allreduce`` of
    the reference's template statistics, ``train_img_horo.py:742-748``).
    Returns replicated :class:`TemplateSums` equal to the single-device
    accumulation over the same tiles (gamma is key-independent and
    batch-split exact; only f32 reduction order differs)."""
    from stainlib_tpu.parallel.collectives import psum_stats

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(axis_name), P()),
        out_specs=P(), check_vma=False)
    def go(p, sp, hsd_shard, k):
        s = _batch_sums(flow, gmm, cfg, p, sp, hsd_shard, k,
                        with_cov=with_cov, with_quantiles=with_quantiles,
                        quantile_space=quantile_space,
                        moment_space=moment_space)
        return psum_stats(s, axis_name)

    hsd = jax.device_put(jnp.asarray(hsd, jnp.float32),
                         NamedSharding(mesh, P(axis_name)))
    return go(params, spectral, hsd, key)


def finalize_stats(sums: TemplateSums, eps: float = 1e-6) -> TemplateStats:
    """:class:`TemplateSums` (after any psum) -> :class:`TemplateStats`."""
    mu, sigma = finalize_template_stats(sums.w, sums.x, sums.xx, eps)
    usage = sums.w / jnp.maximum(jnp.sum(sums.w), 1e-12)
    cov = None
    if sums.xxT is not None:
        tot = jnp.maximum(sums.w, eps)[:, None, None]
        cov = sums.xxT / tot - mu[:, :, None] * mu[:, None, :] \
            + 1e-6 * jnp.eye(3)
    quantiles = None
    if sums.wq is not None:
        quantiles = sums.wq / jnp.maximum(sums.w, eps)[:, None, None]
    return TemplateStats(mu, sigma, usage, cov, quantiles)


def accumulate_template_stats(flow, gmm, cfg: FlowConfig, params, spectral,
                              template_batches: Iterable, key,
                              return_usage: bool = True,
                              return_cov: bool = False,
                              return_quantiles: bool = False,
                              quantile_space: str = "hsd",
                              moment_space: str = "hsd"
                              ) -> TemplateStats:
    """Running-mean template statistics over all template batches
    (``train_img_horo.py:676-727``): a :class:`TemplateStats` with
    (mu, sigma) of shape (K, 3) and the (K,) class-usage shares (for
    :func:`color_eval.match_classes_by_usage`); with ``return_cov`` also
    the (K, 3, 3) full per-class covariances (EXTENSION — feeds
    :func:`color_eval.image_dist_transform_full`); with
    ``return_quantiles`` also the (K, 3, P) per-class quantile curves
    (EXTENSION — feeds :func:`color_eval.image_dist_transform_quantile`;
    mass-weighted average of per-batch curves, i.e. their Wasserstein
    barycenter). ``return_usage`` is kept for signature compatibility;
    usage is always computed (it is free)."""
    del return_usage
    sums = accumulate_template_sums(
        flow, gmm, cfg, params, spectral, template_batches, key,
        with_cov=return_cov, with_quantiles=return_quantiles,
        quantile_space=quantile_space, moment_space=moment_space)
    return finalize_stats(sums)


def finalize_template_stats(sum_w, sum_x, sum_xx, eps: float = 1e-6):
    """Moments -> (mu, sigma). Under multi-host SPMD, psum the three sums
    over the 'data' axis first (the hvd.allreduce of ``:742-744``)."""
    tot = jnp.maximum(sum_w, eps)[:, None]
    mu = sum_x / tot
    sigma = jnp.sqrt(jnp.maximum(sum_xx / tot - mu * mu, eps))
    return mu, sigma


def deploy(flow, gmm, cfg: FlowConfig, params, spectral, test_batches,
           mu_tmpl, sigma_tmpl, key, log=print, usage_tmpl=None,
           cov_tmpl=None, q_tmpl=None, pooled_usage: bool = False,
           q_space: str = "hsd", composite: bool = False):
    """DEPLOY pass: recolor every test batch toward the template and collect
    per-image NMI of the recolored output (``train_img_horo.py:750-862``).

    Returns ``(nmi_values, recolored_batches, (class_nmi, class_nmi_raw))``
    where the last pair holds the reference's per-class NMI arrays
    (:func:`color_eval.nmi_per_class`, shape (N, K)) for the recolored
    output and the un-recolored input. imgs/sec printed per batch (the
    reference's throughput print at ``:862``).

    ``usage_tmpl`` (optional, (K,)): template class-usage shares. When given,
    each batch's classes are rank-matched to the template's by usage before
    the transfer (:func:`color_eval.match_classes_by_usage`) — robust to the
    GMM class permutation measured on out-of-distribution centers; omit for
    the reference's unconditional k -> k mapping.

    ``cov_tmpl`` (optional, (K,3,3)): template per-class covariances from
    ``accumulate_template_stats(return_cov=True)``. When given, the
    transfer uses the full-covariance Monge maps
    (:func:`color_eval.image_dist_transform_full` — EXTENSION, matches
    chroma rotation) instead of the reference's diagonal affine.

    ``q_tmpl`` (optional, (K,3,P)): template per-class quantile curves from
    ``accumulate_template_stats(return_quantiles=True)``. When given, the
    transfer is per-class QUANTILE MATCHING
    (:func:`color_eval.image_dist_transform_quantile` — EXTENSION, closes
    the measured non-affine within-class shifts); takes precedence over
    ``cov_tmpl``. ``q_space`` ('hsd'|'rgb') selects the channels the curves
    were accumulated over and the matching runs in — 'rgb' inverts
    per-RGB-channel acquisition tone curves exactly (``scripts/seg_transfer_demo.py``).

    ``composite`` (with BOTH ``cov_tmpl`` and ``q_tmpl``, accumulated in
    the same ``q_space``): per-class Monge rotation then per-channel
    quantile correction
    (:func:`color_eval.image_dist_transform_full_quantile` — EXTENSION;
    in 'rgb' space the Monge map absorbs per-center linear stain MIXING
    while the quantile step inverts per-channel scanner tone curves,
    ``scripts/seg_transfer_demo.py``). ``mu_tmpl`` must then be accumulated in ``q_space``
    too (``accumulate_template_stats(moment_space=...)``).

    ``pooled_usage`` (with ``usage_tmpl``): accumulate class usage over ALL
    test batches first and use ONE permutation for the whole deploy set —
    the slide-level approach of ``flow_normalize_slide``
    (``slide.py``: one perm from slide-level accumulated usage). Per-BATCH
    matching (the default) recomputes the perm from each batch's own gamma,
    which ``scripts/seg_transfer_demo.py`` measured flipping identity-ordered
    batches (center 1 mIoU 0.93 -> 0.59); pooled matching is the
    stable granularity. Costs one extra encode pass over the test set.
    """
    enc = jax.jit(
        lambda hsd, k: encode(flow, gmm, params, spectral, cfg, hsd, k)
    )
    perm_pooled = None
    if pooled_usage and usage_tmpl is not None:
        test_batches = [jnp.asarray(b, jnp.float32) for b in test_batches]
        k_pool = key
        w_sum = None
        for hsd in test_batches:
            k_pool, sub = jax.random.split(k_pool)
            _, _, gamma = enc(hsd, sub)
            w = jnp.sum(gamma, axis=(0, 1, 2))
            w_sum = w if w_sum is None else w_sum + w
        perm_pooled = color_eval.match_classes_by_usage(
            w_sum / jnp.maximum(jnp.sum(w_sum), 1e-12), usage_tmpl)
    nmis = []
    outs = []
    class_nmis = []  # (B, K) per batch — the reference's per-class metric
    class_nmis_raw = []  # same statistic on the un-recolored input
    meter = Throughput()
    for hsd in test_batches:
        hsd = jnp.asarray(hsd, jnp.float32)
        key, sub = jax.random.split(key)
        _, _, gamma = enc(hsd, sub)
        # Source stats pooled over the batch — exactly the reference: the
        # GMM head returns ONE (mu, std) per deploy batch
        # (train_img_horo.py:703-705, applied at :815).
        perm = (perm_pooled if perm_pooled is not None
                else color_eval.match_classes_by_usage(
                    color_eval.class_usage(gamma), usage_tmpl)
                if usage_tmpl is not None else None)
        if composite and q_tmpl is not None and cov_tmpl is not None:
            xq = hsd if q_space == "hsd" else hsd_to_rgb(hsd)
            mu_s, cov_s = color_eval.class_color_cov(xq, gamma)
            rgb = color_eval.image_dist_transform_full_quantile(
                xq, gamma, mu_s, cov_s, mu_tmpl, cov_tmpl, q_tmpl,
                perm=perm, space=q_space)
        elif q_tmpl is not None:
            xq = hsd if q_space == "hsd" else hsd_to_rgb(hsd)
            q_src, _ = color_eval.class_channel_quantiles(xq, gamma)
            rgb = color_eval.image_dist_transform_quantile(
                xq, gamma, q_src, q_tmpl, perm=perm, space=q_space)
        elif cov_tmpl is not None:
            mu_s, cov_s = color_eval.class_color_cov(hsd, gamma)
            rgb = color_eval.image_dist_transform_full(
                hsd, gamma, mu_s, cov_s, mu_tmpl, cov_tmpl, perm=perm)
        else:
            mu_s, sd_s = color_eval.class_color_stats(hsd, gamma)
            rgb = color_eval.image_dist_transform(
                hsd, gamma, mu_s, sd_s, mu_tmpl, sigma_tmpl, perm=perm
            )
        mask = tissue_mask(rgb).mask
        for i in range(rgb.shape[0]):
            nmis.append(float(color_eval.nmi(rgb[i], mask[i])))
        # One device->host transfer each for rgb/gamma, reused below.
        rgb_np = np.asarray(rgb)
        gamma_np = np.asarray(gamma)
        class_nmis.append(color_eval.nmi_per_class(rgb_np, gamma_np))
        class_nmis_raw.append(color_eval.nmi_per_class(
            np.asarray(to_uint8(hsd_to_rgb(hsd))), gamma_np))
        outs.append(rgb_np)
        log(f"deploy: {meter.tick(int(rgb.shape[0])):.1f} imgs/sec")
    return np.asarray(nmis), outs, (np.concatenate(class_nmis),
                                    np.concatenate(class_nmis_raw))


def validate(flow, gmm, cfg: FlowConfig, params, spectral,
             template_batches, test_batches, key,
             out_dir: Optional[str] = None, log=print,
             class_match: bool = False, transfer: str = "diag",
             mesh=None, axis_name: str = "data",
             pooled_class_match: bool = False):
    """Full validate(): template stats -> deploy -> NMI SD/CV (+ CSV).
    ``class_match`` enables usage-rank class matching at deploy (see
    :func:`deploy`); off = the reference's k -> k mapping.
    ``transfer``: 'diag' = the reference's per-channel affine
    (``train_img_horo.py:815``); 'full' = per-class Monge maps
    (EXTENSION — :func:`color_eval.image_dist_transform_full`);
    'quantile' = per-class quantile matching (EXTENSION —
    :func:`color_eval.image_dist_transform_quantile`);
    'rgb-quantile' = the same matching on the float-RGB rendering — the
    space where acquisition tone curves are per-channel monotone and thus
    exactly invertible (EXTENSION, ``scripts/seg_transfer_demo.py``);
    'full-quantile' / 'rgb-full-quantile' = the COMPOSITE (per-class Monge
    rotation, then per-channel quantile correction;
    :func:`color_eval.image_dist_transform_full_quantile`) in HSD / RGB —
    the RGB composite handles per-center linear stain mixing AND monotone
    tone curves together (EXTENSION, ``scripts/seg_transfer_demo.py``).
    ``mesh``: when given, each template batch is SHARDED over
    ``mesh[axis_name]`` and its statistic sums are allreduced in-program
    (:func:`template_sums_sharded`) — the reference's data-parallel
    template pass with its ``hvd.allreduce`` (``train_img_horo.py:
    742-748``); the batch size must divide by the axis size."""
    transfers = ("diag", "full", "quantile", "rgb-quantile",
                 "full-quantile", "rgb-full-quantile")
    if transfer not in transfers:
        raise ValueError(f"transfer must be one of {transfers}, "
                         f"got {transfer!r}")
    q_space = "rgb" if transfer.startswith("rgb-") else "hsd"
    with_q = transfer.endswith("quantile")
    composite = transfer in ("full-quantile", "rgb-full-quantile")
    with_cov = transfer == "full" or composite
    # The composite consumes mu/cov in the SAME space as its quantile
    # curves (deploy() contract); plain 'full' keeps the HSD moments.
    m_space = q_space if composite else "hsd"
    k1, k2 = jax.random.split(key)
    if mesh is not None:
        sums = None
        for hsd in template_batches:
            k1, sub = jax.random.split(k1)
            s = template_sums_sharded(
                flow, gmm, cfg, params, spectral, hsd, sub, mesh,
                axis_name=axis_name, with_cov=with_cov,
                with_quantiles=with_q, quantile_space=q_space,
                moment_space=m_space)
            sums = s if sums is None else jax.tree.map(jnp.add, sums, s)
        stats = finalize_stats(sums)
    else:
        stats = accumulate_template_stats(
            flow, gmm, cfg, params, spectral, template_batches, k1,
            return_cov=with_cov,
            return_quantiles=with_q, quantile_space=q_space,
            moment_space=m_space
        )
    mu_t, sd_t = stats.mu, stats.sigma
    nmis, outs, (cls_nmi, cls_nmi_raw) = deploy(
        flow, gmm, cfg, params, spectral, test_batches,
        mu_t, sd_t, k2, log=log,
        usage_tmpl=stats.usage if class_match else None,
        cov_tmpl=stats.cov, q_tmpl=stats.quantiles,
        pooled_usage=pooled_class_match, q_space=q_space,
        composite=composite)
    sd, cv = color_eval.nmi_sd_cv(nmis)
    # The reference metric: per-class SD/CV averaged across classes
    # (train_img_horo.py:865-898), before and after recoloring.
    csd, ccv, per_class = color_eval.class_nmi_sd_cv(cls_nmi)
    csd_raw, ccv_raw, _ = color_eval.class_nmi_sd_cv(cls_nmi_raw)
    log(f"validate: NMI sd={sd:.4f} cv={cv:.4f} over {len(nmis)} images; "
        f"per-class avg sd={csd:.4f} cv={ccv:.4f} "
        f"(raw {csd_raw:.4f}/{ccv_raw:.4f})")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "nmi_metrics.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["nmi"])
            w.writerows([[v] for v in nmis])
            w.writerow([])
            w.writerow(["sd", sd])
            w.writerow(["cv", cv])
    return {"nmi_sd": sd, "nmi_cv": cv, "nmi": nmis, "outputs": outs,
            "class_nmi_sd": csd, "class_nmi_cv": ccv,
            "class_nmi_sd_raw": csd_raw, "class_nmi_cv_raw": ccv_raw,
            "class_nmi": cls_nmi, "class_nmi_per_class": per_class,
            "mu_tmpl": np.asarray(mu_t), "sigma_tmpl": np.asarray(sd_t)}


def save_visuals(out_dir: str, step: int, hsd_tmpl, hsd_test, rgb_converted,
                 gamma):
    """PNG dumps of template / test / converted images and class-membership
    maps (``visualize``/``savegamma``, ``train_img_horo.py:632-656,
    933-1074``)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)

    def dump(name, arr):
        Image.fromarray(np.asarray(arr)).save(
            os.path.join(out_dir, f"{name}_{step:06d}.png")
        )

    dump("im_tmpl", np.asarray(to_uint8(hsd_to_rgb(hsd_tmpl[0]))))
    dump("im_test", np.asarray(to_uint8(hsd_to_rgb(hsd_test[0]))))
    dump("im_conv", np.asarray(rgb_converted[0]))
    # Class-membership color map: argmax class -> distinct hue.
    k = gamma.shape[-1]
    palette = (np.linspace(0, 255, k)[:, None] * np.array([[1.0, 0.5, 0.25]]))
    classes = np.asarray(jnp.argmax(gamma[0], axis=-1))
    dump("im_gamma", palette[classes].astype(np.uint8))
