"""Whole-slide stain normalization: stream a WSI through the device, write a WSI.

The reference's deployment story is the ``tester`` loop: iterate every tile
of a slide through OpenSlide/PyVips decode and a per-patch CPU transform
(``dlmodels/color-information/data_utils.py:1``; per-patch normalization
``stainlib/normalization/normalizer.py:39-50``). This module is the
batched end-to-end equivalent as a single call: threaded native TIFF
decode (``data/native.py``), an overlapped host->device prefetch ring
(``data/pipeline.py``), one jitted normalization program per tile batch
on-device, and a tiled pyramidal TIFF written back out.

Estimation modes:

* ``estimation='slide'`` (default): ONE stain matrix + maxC for the whole
  slide, fitted on a mosaic of rejection-sampled tissue tiles, then applied
  to every tile with the fixed-matrix transform
  (``extractive.transform_with_matrix``). A slide is one staining event, so
  one estimate is the physically meaningful choice — and adjacent tiles
  share one color map, so the output has no tile-boundary seams. The
  per-tile percentile machinery drops out entirely; the apply is a pure
  per-pixel pass.
* ``estimation='tile'``: the reference's exact per-patch semantics
  (re-estimate per tile, ``normalizer.py:45-48``) via the functional
  per-tile transform.
"""

from __future__ import annotations

import functools
import math
import os
import tempfile
from typing import Callable, NamedTuple, Optional, Union

import numpy as np

import jax
import jax.numpy as jnp

# Above this many bytes a canvas/pyramid level is backed by a disk memmap
# instead of host RAM: the reference's ``tester`` deployment iterates 100k+
# tiles per slide (``data_utils.py:1``), i.e. level-0 canvases of tens of
# GB that must not be required to fit in memory.
_RAM_CANVAS_BYTES = 1 << 30


def _alloc_u8(shape):
    """uint8 array of ``shape``: plain RAM below ``_RAM_CANVAS_BYTES``, an
    anonymous disk-backed memmap above (the file is unlinked immediately;
    space is reclaimed when the array is garbage collected)."""
    nbytes = int(np.prod(shape))
    if nbytes <= _RAM_CANVAS_BYTES:
        return np.empty(shape, np.uint8)
    f = tempfile.NamedTemporaryFile(prefix="stainlib_canvas_", delete=False)
    f.close()
    arr = np.memmap(f.name, dtype=np.uint8, mode="w+", shape=shape)
    os.unlink(f.name)
    return arr


class SlideStainParams(NamedTuple):
    """Slide-level source estimate: one stain matrix + 99th-pct maxC."""

    stain_matrix: np.ndarray  # (2, 3)
    max_c: np.ndarray  # (2,)


class SlideReinhardParams(NamedTuple):
    """Slide-level Reinhard source estimate: LAB stats + brightness p90."""

    stats: "object"  # reinhard.ReinhardParams
    brightness_divisor: float


def _open(slide_or_path):
    from stainlib_tpu.data.native import open_slide

    if isinstance(slide_or_path, (str, bytes)):
        return open_slide(slide_or_path), True
    return slide_or_path, False


def _sample_mosaic(slide, level: int, tile: int, n_tiles: int, seed: int):
    """Rejection-sampled tissue tiles stacked into one tall (n*t, t, 3)
    image — percentiles/covariances over the mosaic ARE statistics over the
    sampled tissue pixels (the white/stddev rejection mirrors the
    reference sampler's background filter, ``data_utils.py:1``)."""
    tiles, coords = slide.sample_tiles(level, tile, n_tiles, seed=seed)
    kept = tiles[(coords[:, 0] >= 0)]
    if len(kept) == 0:  # all-background slide: fall back to whatever came
        kept = tiles
    return kept.reshape(-1, tile, 3)


def fit_slide(slide_or_path, method: str = "macenko", level: int = 0,
              tile: int = 256, n_tiles: int = 32, seed: int = 0,
              regularizer: float = 0.01,
              **extractor_kwargs) -> SlideStainParams:
    """Estimate one (stain matrix, maxC) for a whole slide from a mosaic of
    rejection-sampled tissue tiles (Macenko or Vahadane). The mosaic's
    pixel count (n_tiles * tile^2, default 2M) rides the streaming
    count-bisection percentiles (``ops/percentile.py``)."""
    slide, owned = _open(slide_or_path)
    try:
        mosaic = _sample_mosaic(slide, level, tile, n_tiles, seed)
    finally:
        if owned:
            slide.close()
    from stainlib_tpu.normalization import extractive

    # One jitted dispatch instead of an eager op-by-op fit.
    fit_fn = jax.jit(functools.partial(extractive.fit, method=method,
                                       regularizer=regularizer,
                                       **extractor_kwargs))
    p = jax.device_get(fit_fn(jnp.asarray(mosaic)))
    return SlideStainParams(
        stain_matrix=np.asarray(p.stain_matrix_target),
        max_c=np.asarray(p.max_c_target))


def fit_slide_reinhard(slide_or_path, level: int = 0, tile: int = 256,
                       n_tiles: int = 32, seed: int = 0,
                       quantize: bool = True) -> SlideReinhardParams:
    """Slide-level Reinhard source statistics: the 90th-percentile
    brightness divisor and the post-standardization LAB mean/std of the
    tissue mosaic (the per-image quantities of ``normalizer.py:70-83``
    hoisted to slide scope)."""
    slide, owned = _open(slide_or_path)
    try:
        mosaic = _sample_mosaic(slide, level, tile, n_tiles, seed)
    finally:
        if owned:
            slide.close()
    from stainlib_tpu.normalization import reinhard
    from stainlib_tpu.ops.percentile import percentile

    @jax.jit
    def fit_fn(m):
        x = jnp.asarray(m, jnp.float32)
        p90 = percentile(x.reshape(-1), 90.0, axis=0)
        return reinhard.fit(m, quantize=quantize), p90

    stats, p90 = jax.device_get(fit_fn(jnp.asarray(mosaic)))
    return SlideReinhardParams(stats=stats,
                               brightness_divisor=float(p90))


def _grid_coords(W: int, H: int, tile: int):
    xs = list(range(0, W, tile))
    ys = list(range(0, H, tile))
    return [(x, y) for y in ys for x in xs]


def _make_apply(method: str, estimation: str, target_params, src,
                regularizer: float, mesh=None, mesh_axis: str = "data"):
    """Returns one jitted (B, t, t, 3) uint8 -> (B, t, t, 3) uint8 apply.

    With ``mesh`` set, the transform runs under ``shard_map`` with the
    batch axis sharded over ``mesh_axis``: every device runs the identical
    pipeline on its tile shard, collective-free — the per-rank model
    execution of the reference's deployment (``train_img_horo.py:541-594``)
    scaled over a device mesh. The batch size must then be a multiple of
    the mesh's ``mesh_axis`` axis size."""
    from stainlib_tpu.normalization import extractive, reinhard

    if method == "reinhard":
        if estimation == "slide":
            # Slide-level source stats: a pure per-pixel affine.
            def core(batch):
                return reinhard.transform(
                    target_params, batch, source_stats=src.stats,
                    brightness_divisor=src.brightness_divisor)
        else:
            # The reference's per-image source stats
            # (``normalizer.py:70-83``).
            def core(batch):
                return reinhard.transform(target_params, batch)
    elif estimation == "slide":
        def core(batch):
            return extractive.transform_with_matrix(
                batch, src.stain_matrix, src.max_c,
                target_params, regularizer=regularizer)
    else:
        # estimation == 'tile': the reference's exact per-patch semantics.
        def core(batch):
            return extractive.transform(target_params, batch, method=method,
                                        regularizer=regularizer)

    # One jitted dispatch per batch.
    if mesh is None:
        return jax.jit(core)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    spec = P(mesh_axis, None, None, None)
    return jax.jit(shard_map(core, mesh=mesh, in_specs=(spec,),
                             out_specs=spec, check_vma=False))


def build_pyramid(level0: np.ndarray, min_dim: int = 512):
    """2x box-mean reduced-resolution levels down to ``min_dim`` (the .svs
    layout the native writer emits; odd trailing rows/cols are cropped,
    matching how scanners truncate). Each level is reduced in row chunks
    (~64 MB of intermediate at a time) and lands in RAM or a disk memmap
    via :func:`_alloc_u8`, so reference-scale slides (tens of GB at level
    0) never need a full-level uint16 temporary in memory."""
    levels = [level0]
    cur = level0
    while min(cur.shape[0] // 2, cur.shape[1] // 2) >= min_dim:
        h2, w2 = cur.shape[0] // 2, cur.shape[1] // 2
        nxt = _alloc_u8((h2, w2, 3))
        step = max(1, (64 << 20) // max(w2 * 12, 1))  # rows per chunk
        for r0 in range(0, h2, step):
            r1 = min(r0 + step, h2)
            c = cur[2 * r0 : 2 * r1, : 2 * w2].astype(np.uint16)
            nxt[r0:r1] = ((c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
                           + c[1::2, 1::2] + 2) // 4).astype(np.uint8)
        levels.append(nxt)
        cur = nxt
    return levels


def _stream_canvas(slide, level: int, tile: int, batch: int, W: int, H: int,
                   apply_fn, progress, prefetch_depth: int,
                   prefetch_workers: int, sharding=None):
    """Stream the tile grid through ``apply_fn(dev_batch, batch_index)``
    (threaded decode -> prefetch ring -> device) into an (H, W, 3) canvas.
    ``sharding``: optional NamedSharding for the prefetched batches (mesh
    deployment — each DMA lands pre-sharded across the mesh)."""
    from stainlib_tpu.data.pipeline import DevicePrefetcher

    coords = _grid_coords(W, H, tile)
    n_batches = math.ceil(len(coords) / batch)
    canvas = _alloc_u8((H, W, 3))
    read_regions = getattr(slide, "read_regions", None)
    # Coordinates stay host-side (the device never needs them). The
    # trailing partial batch is padded by
    # repeating its last coordinate so every dispatch shares ONE jitted
    # shape (no second compile); the writer crops via the unpadded chunk.
    chunks = [coords[i * batch : (i + 1) * batch] for i in range(n_batches)]

    def host_batches():
        for chunk in chunks:
            padded = chunk + [chunk[-1]] * (batch - len(chunk))
            if read_regions is not None:  # threaded native batch decode
                yield read_regions(level, np.asarray(padded, np.int64),
                                   tile, tile)
            else:  # WSIRAW mmap slides decode per region
                yield np.stack([
                    slide.read_region(level, int(x), int(y), tile, tile)
                    for x, y in padded])

    pf = DevicePrefetcher(host_batches(), depth=prefetch_depth,
                          workers=prefetch_workers, sharding=sharding)
    for bi, dev_batch in enumerate(pf):
        out = np.asarray(apply_fn(dev_batch, bi))
        for (x, y), img in zip(chunks[bi], out):
            h_v = min(tile, H - y)
            w_v = min(tile, W - x)
            canvas[y : y + h_v, x : x + w_v] = img[:h_v, :w_v]
        if progress is not None:
            progress(bi + 1, n_batches)
    return canvas, len(coords)


def normalize_slide(
    src_path: str,
    out_path: str,
    target,
    method: str = "macenko",
    estimation: str = "slide",
    tile: int = 256,
    batch: int = 64,
    level: int = 0,
    n_fit_tiles: int = 32,
    seed: int = 0,
    regularizer: float = 0.01,
    min_pyramid: int = 512,
    compression: str = "jpeg",
    quality: int = 90,
    prefetch_depth: int = 3,
    prefetch_workers: int = 2,
    progress: Optional[Callable[[int, int], None]] = None,
    mesh=None,
    mesh_axis: str = "data",
) -> dict:
    """Normalize every tile of a WSI toward ``target`` and write a tiled
    pyramidal TIFF. Returns a summary dict (dims, tiles, modes).

    ``target``: an (H, W, 3) uint8 target image, a path to one, or
    pre-fitted params (``ExtractiveParams`` / ``ReinhardParams``).
    ``estimation``: 'slide' (one stain estimate for the whole slide;
    seam-free, fastest) or 'tile' (the reference's per-patch re-estimation,
    ``normalizer.py:45-48``).
    ``mesh``: an optional ``jax.sharding.Mesh`` — tile batches are sharded
    over ``mesh_axis`` and every device normalizes its shard under
    ``shard_map`` (scale-out deployment; output is bit-identical to the
    single-device path). ``batch`` must be a multiple of the mesh's
    ``mesh_axis`` axis size.
    """
    from stainlib_tpu.data.native import write_tiff_pyramid
    from stainlib_tpu.normalization import extractive, reinhard

    method = method.lower()
    if method not in ("macenko", "vahadane", "reinhard"):
        raise ValueError(f"unknown method {method!r}")
    if estimation not in ("slide", "tile"):
        raise ValueError(f"unknown estimation {estimation!r}")

    # Target params.
    if isinstance(target, (str, bytes)):
        from PIL import Image

        target = np.asarray(Image.open(target).convert("RGB"))
    if isinstance(target, (extractive.ExtractiveParams,
                           reinhard.ReinhardParams)):
        target_params = target
    elif method == "reinhard":
        target_params = jax.device_get(
            jax.jit(reinhard.fit)(jnp.asarray(target)))
    else:
        target_params = jax.device_get(jax.jit(functools.partial(
            extractive.fit, method=method, regularizer=regularizer))(
                jnp.asarray(target)))

    slide, _ = _open(src_path)
    try:
        W, H = slide.level_size(level)

        # Slide-level source estimation.
        src = None
        if estimation == "slide":
            if method == "reinhard":
                src = fit_slide_reinhard(slide, level=level, tile=tile,
                                         n_tiles=n_fit_tiles, seed=seed)
            else:
                src = fit_slide(slide, method=method, level=level, tile=tile,
                                n_tiles=n_fit_tiles, seed=seed,
                                regularizer=regularizer)

        sharding = None
        if mesh is not None:
            if mesh_axis not in mesh.shape:
                raise ValueError(
                    f"mesh_axis {mesh_axis!r} not in mesh axes "
                    f"{tuple(mesh.shape)}")
            # Divisibility is against the SHARDED axis, not the total
            # device count: on a multi-axis mesh the batch only splits
            # over mesh_axis (other axes replicate the shard).
            axis_size = int(mesh.shape[mesh_axis])
            if batch % axis_size:
                raise ValueError(
                    f"batch ({batch}) must be a multiple of the mesh's "
                    f"{mesh_axis!r} axis size ({axis_size})")
            from jax.sharding import NamedSharding, PartitionSpec

            sharding = NamedSharding(
                mesh, PartitionSpec(mesh_axis, None, None, None))

        apply_fn = _make_apply(method, estimation, target_params, src,
                               regularizer, mesh=mesh, mesh_axis=mesh_axis)

        canvas, n_tiles = _stream_canvas(
            slide, level, tile, batch, W, H,
            lambda dev_batch, _bi: apply_fn(dev_batch), progress,
            prefetch_depth, prefetch_workers, sharding=sharding)

        levels = build_pyramid(canvas, min_dim=min_pyramid)
        write_tiff_pyramid(out_path, levels, tile=tile,
                           compression=compression, quality=quality)
        return {
            "width": W,
            "height": H,
            "tiles": n_tiles,
            "levels": len(levels),
            "method": method,
            "estimation": estimation,
        }
    finally:
        slide.close()


def flow_normalize_slide(
    src_path: str,
    out_path: str,
    ckpt_dir: str,
    template=None,
    batch: int = 8,
    level: int = 0,
    n_src_tiles: int = 32,
    seed: int = 0,
    min_pyramid: int = 512,
    compression: str = "jpeg",
    quality: int = 90,
    prefetch_depth: int = 3,
    prefetch_workers: int = 2,
    progress: Optional[Callable[[int, int], None]] = None,
    cfg=None,
    use_ema: bool = True,
    class_match: bool = False,
    transfer: str = "diag",
) -> dict:
    """Whole-slide color normalization with the trained residual-flow+GMM
    at the reference's published capacity — the ``validate``/deploy loop of
    ``train_img_horo.py:658-930`` (template stats -> per-class HSD
    distribution transfer, ``:815``) applied to EVERY tile of a WSI, with
    the output written back as a pyramidal TIFF.

    ``ckpt_dir``: a ``utils/checkpoint.py`` directory holding the
    ``reference_capacity()`` training state (502,855 params; see
    ``scripts/train_flow_capacity.py``).
    ``template``: (N, S, S, 3) uint8 template tiles, a template slide path
    to sample from, or None for synthetic center 0 — the reference's
    template loader (``:682-726``).

    Deviation from the reference's deploy: source color statistics are
    accumulated once over ``n_src_tiles`` sampled tiles of the WHOLE slide
    (not per test batch, ``:803-812``), so every tile is recolored through
    one slide-level map and the output has no batch-boundary seams.

    ``class_match``: rank-match the slide's GMM classes to the template's by
    usage share before the transfer (robust to the class permutation
    measured on out-of-distribution centers by
    ``scripts/seg_transfer_demo.py``); off = the
    reference's unconditional k -> k mapping.

    ``transfer``: 'diag' = the reference's per-channel (mu, sigma) affine
    (``train_img_horo.py:815``); 'full' = full-covariance per-class Monge
    maps (EXTENSION — ``color_eval.image_dist_transform_full``, matches the
    template's chroma rotation); 'quantile' = per-class quantile matching
    (EXTENSION — ``color_eval.image_dist_transform_quantile``, closes the
    measured non-affine within-class shifts; both measured on the synthetic
    cohort by ``scripts/seg_transfer_demo.py``); 'rgb-quantile' = the same matching on the
    float-RGB rendering, the space where scanner tone curves are
    per-channel monotone and exactly invertible (EXTENSION; the
    acquisition cohort of ``scripts/seg_transfer_demo.py``).
    """
    import jax  # noqa: F401  (jitted closures below)

    from stainlib_tpu.data.native import write_tiff_pyramid
    from stainlib_tpu.models import color_eval
    from stainlib_tpu.models.train_flow import (
        encode, init_flow_state, reference_capacity)
    from stainlib_tpu.models.validate_flow import accumulate_template_stats
    from stainlib_tpu.ops.colorspace import hsd_to_rgb, rgb_to_hsd
    from stainlib_tpu.utils.checkpoint import restore_checkpoint

    if cfg is None:
        cfg = reference_capacity()
    tile = cfg.image_size
    to_hsd = jax.jit(rgb_to_hsd)

    # Template tiles -> HSD batches.
    if template is None:
        from stainlib_tpu.data.synthetic import center_tiles

        template = center_tiles(0, max(batch * 4, 32), tile, tile,
                                seed=seed + 100)
    elif isinstance(template, (str, bytes)):
        t_slide, _ = _open(template)
        try:
            tiles_np, _ = t_slide.sample_tiles(level, tile,
                                               max(batch * 4, 32),
                                               seed=seed + 100)
        finally:
            t_slide.close()
        template = tiles_np
    template = np.asarray(template)
    tmpl_hsd = np.asarray(to_hsd(jnp.asarray(template)))

    # Restore the capacity checkpoint.
    flow, gmm, state, _ = init_flow_state(
        cfg, jax.random.PRNGKey(seed), sample_hsd=tmpl_hsd[:batch])
    state = restore_checkpoint(ckpt_dir, state)
    # Deploy with the EMA weights by default — the reference's validation
    # swap (``--ema-val``, ``train_img_horo.py:668-669``). Measured r3: at
    # the converged 1000-step capacity checkpoint the EMA weights transfer
    # at NMI sd 0.0583 vs 0.0753 for the raw weights
    # (``scripts/train_flow_capacity.py --ema-val``).
    params = state.ema.params if use_ema else state.params
    spectral = state.spectral

    if transfer not in ("diag", "full", "quantile", "rgb-quantile"):
        raise ValueError(
            "transfer must be 'diag', 'full', 'quantile' or 'rgb-quantile', "
            f"got {transfer!r}")
    full = transfer == "full"
    quant = transfer in ("quantile", "rgb-quantile")
    q_space = "rgb" if transfer == "rgb-quantile" else "hsd"
    key = jax.random.PRNGKey(seed + 1)
    k_tmpl, k_src, key = jax.random.split(key, 3)
    t_stats = accumulate_template_stats(
        flow, gmm, cfg, params, spectral,
        [tmpl_hsd[i : i + batch] for i in range(0, len(tmpl_hsd), batch)],
        k_tmpl, return_cov=full, return_quantiles=quant,
        quantile_space=q_space)
    mu_t, sd_t, usage_t = t_stats.mu, t_stats.sigma, t_stats.usage
    cov_t, q_t = t_stats.cov, t_stats.quantiles

    slide, _ = _open(src_path)
    try:
        W, H = slide.level_size(level)

        # Slide-level SOURCE statistics from sampled tissue tiles. Slots
        # whose rejection sampling failed come back as gray filler with
        # coords (-1, -1) (``data/wsi.py``); keep tissue tiles only, same
        # guard as ``_sample_mosaic``.
        src_tiles, src_xy = slide.sample_tiles(level, tile, n_src_tiles,
                                               seed=seed)
        kept = src_tiles[src_xy[:, 0] >= 0]
        if len(kept):
            src_tiles = kept
        src_hsd = np.asarray(to_hsd(jnp.asarray(src_tiles)))
        s_stats = accumulate_template_stats(
            flow, gmm, cfg, params, spectral,
            [src_hsd[i : i + batch] for i in range(0, len(src_hsd), batch)],
            k_src, return_cov=full, return_quantiles=quant,
            quantile_space=q_space)
        mu_s, sd_s, usage_s = s_stats.mu, s_stats.sigma, s_stats.usage
        cov_s, q_s = s_stats.cov, s_stats.quantiles
        # One slide-level permutation, matching the slide-level source
        # statistics above (no per-batch seams either way).
        perm = (color_eval.match_classes_by_usage(usage_s, usage_t)
                if class_match else None)

        @jax.jit
        def recolor(batch_u8, bi):
            # Per-batch PRNG derived in-graph: no pre-split key table to
            # outgrow (a real 40x WSI exceeds 100k batches), no per-batch
            # host dispatch.
            k = jax.random.fold_in(key, bi)
            hsd = rgb_to_hsd(batch_u8)
            _, _, gamma = encode(flow, gmm, params, spectral, cfg, hsd, k)
            if quant:
                # rgb-quantile maps the same float-RGB rendering the curves
                # were accumulated over (hsd_to_rgb of the HSD encoding).
                xq = hsd if q_space == "hsd" else hsd_to_rgb(hsd)
                return color_eval.image_dist_transform_quantile(
                    xq, gamma, q_s, q_t, perm=perm, space=q_space)
            if full:
                return color_eval.image_dist_transform_full(
                    hsd, gamma, mu_s, cov_s, mu_t, cov_t, perm=perm)
            return color_eval.image_dist_transform(
                hsd, gamma, mu_s, sd_s, mu_t, sd_t, perm=perm)

        canvas, n_tiles = _stream_canvas(
            slide, level, tile, batch, W, H,
            lambda dev_batch, bi: recolor(dev_batch, np.uint32(bi)),
            progress, prefetch_depth, prefetch_workers)

        levels = build_pyramid(canvas, min_dim=min_pyramid)
        write_tiff_pyramid(out_path, levels, tile=tile,
                           compression=compression, quality=quality)
        return {
            "width": W, "height": H, "tiles": n_tiles,
            "levels": len(levels), "method": "flow",
            "params": int(sum(int(np.prod(np.shape(p)))
                              for p in jax.tree.leaves(params))),
            "step": int(state.step),
            "ema": use_ema,
        }
    finally:
        slide.close()
