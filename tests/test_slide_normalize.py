"""Whole-slide normalization: fixed-matrix transform + the end-to-end
slide->slide driver (the reference's ``tester`` deployment loop,
``data_utils.py:1`` + ``normalizer.py:39-50``, as one call)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stainlib_tpu.data import native
from stainlib_tpu.normalization import extractive
from stainlib_tpu.normalization.slide import (
    build_pyramid, fit_slide, normalize_slide)
from tests.synth import he_batch, he_patch

requires_native = pytest.mark.skipif(
    not native.tiff_native_available(), reason="libtiff toolchain missing")

# A target with a deliberately different stain geometry than HE_TRUE.
TGT_STAIN = np.array([[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]])
TGT_STAIN = TGT_STAIN / np.linalg.norm(TGT_STAIN, axis=1, keepdims=True)


def test_transform_with_matrix_matches_per_image_path():
    """With the matrix/maxC taken FROM the image, the fixed-matrix
    transform must reproduce the per-image re-estimating transform."""
    target = he_patch(32, 64, seed=10, stain=TGT_STAIN)
    img = he_patch(32, 64, seed=11)
    params = extractive.fit(jnp.asarray(target), method="macenko")
    src = extractive.fit(jnp.asarray(img), method="macenko")
    want = np.asarray(extractive.transform(params, jnp.asarray(img)))
    got = np.asarray(extractive.transform_with_matrix(
        jnp.asarray(img), src.stain_matrix_target, src.max_c_target, params))
    assert (got == want).all()


@pytest.mark.parametrize("method,estimation", [
    ("macenko", "slide"), ("macenko", "tile"), ("vahadane", "tile"),
    ("reinhard", "slide"), ("reinhard", "tile")])
def test_make_apply_routes_to_functional(method, estimation):
    """Each (method, estimation) apply is the functional transform it
    names, bit for bit."""
    from stainlib_tpu.normalization import reinhard
    from stainlib_tpu.normalization.slide import (
        SlideReinhardParams, SlideStainParams, _make_apply)

    target = jnp.asarray(he_patch(32, 64, seed=20, stain=TGT_STAIN))
    batch = jnp.asarray(he_batch(3, 32, 64, seed=21))
    src = None
    if method == "reinhard":
        params = reinhard.fit(target)
        if estimation == "slide":
            src = SlideReinhardParams(stats=reinhard.fit(batch[0]),
                                      brightness_divisor=230.0)

            def direct(x):
                return reinhard.transform(params, x, source_stats=src.stats,
                                          brightness_divisor=230.0)
        else:
            def direct(x):
                return reinhard.transform(params, x)
    else:
        params = extractive.fit(target, method=method)
        if estimation == "slide":
            s = extractive.fit(batch[0], method=method)
            src = SlideStainParams(stain_matrix=s.stain_matrix_target,
                                   max_c=s.max_c_target)

            def direct(x):
                return extractive.transform_with_matrix(
                    x, src.stain_matrix, src.max_c, params)
        else:
            def direct(x):
                return extractive.transform(params, x, method=method)
    want = jax.jit(direct)(batch)
    apply_fn = _make_apply(method, estimation, params, src, 0.01)
    np.testing.assert_array_equal(np.asarray(apply_fn(batch)),
                                  np.asarray(want))


def _tissue_slide(tmp_path, h=520, w=600, seed=0):
    """A lossless (deflate) synthetic tissue slide covering edge tiles."""
    tiles = he_batch(9, 256, 256, seed=seed, background_frac=0.0)
    lv0 = np.concatenate(
        [np.concatenate(list(tiles[r * 3 : r * 3 + 3]), axis=1)
         for r in range(3)], axis=0)[:h, :w]
    lv0[:24] = 255  # a white margin band
    path = str(tmp_path / "tissue.tif")
    native.write_tiff_pyramid(path, [lv0], tile=128, compression="deflate")
    return path, lv0


@requires_native
def test_fit_slide_recovers_stain_geometry(tmp_path):
    path, _ = _tissue_slide(tmp_path)
    p = fit_slide(path, method="macenko", n_tiles=8, seed=3)
    assert p.stain_matrix.shape == (2, 3) and p.max_c.shape == (2,)
    np.testing.assert_allclose(
        np.linalg.norm(p.stain_matrix, axis=1), 1.0, atol=1e-5)
    assert (p.max_c > 0).all()
    # H (first row) has the larger red OD, the reference's ordering rule.
    assert p.stain_matrix[0, 0] > p.stain_matrix[1, 0]


@requires_native
def test_normalize_slide_end_to_end_slide_mode(tmp_path):
    path, lv0 = _tissue_slide(tmp_path)
    out_path = str(tmp_path / "norm.tif")
    target = he_patch(256, 256, seed=40, stain=TGT_STAIN,
                      background_frac=0.0)
    info = normalize_slide(path, out_path, target, method="macenko",
                           estimation="slide", batch=4, n_fit_tiles=8,
                           seed=3, compression="deflate")
    assert info["tiles"] == 9 and info["estimation"] == "slide"

    s = native.TiffSlide(out_path)
    assert s.level_size(0) == (600, 520)
    got = s.read_region(0, 0, 0, 600, 520)
    s.close()
    # White margin stays white (OD ~ 0 -> concentrations ~ 0 -> white).
    assert got[:16].min() >= 250
    # Tissue actually moved toward the target stain geometry.
    assert np.abs(got[200:400, 100:500].astype(int)
                  - lv0[200:400, 100:500].astype(int)).mean() > 2.0

    # The written interior tile equals the fixed-matrix transform applied
    # directly (canvas placement + prefetch order are lossless).
    src = fit_slide(path, method="macenko", n_tiles=8, seed=3)
    params = extractive.fit(jnp.asarray(target), method="macenko")
    tile_in = lv0[256:512, 256:512]
    want = np.asarray(extractive.transform_with_matrix(
        jnp.asarray(tile_in[None]), src.stain_matrix, src.max_c, params))[0]
    # Up to 1 uint8 step: the driver transforms batches of 4, whose XLA
    # fusion rounds a handful of pixels differently than a 1-image call.
    diff = np.abs(got[256:512, 256:512].astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() > 0.99, (
        diff.max(), (diff == 0).mean())


@requires_native
def test_normalize_slide_tile_mode_matches_reference_semantics(tmp_path):
    path, lv0 = _tissue_slide(tmp_path)
    out_path = str(tmp_path / "norm_tile.tif")
    target = he_patch(256, 256, seed=41, stain=TGT_STAIN,
                      background_frac=0.0)
    normalize_slide(path, out_path, target, method="macenko",
                    estimation="tile", batch=4, compression="deflate")
    s = native.TiffSlide(out_path)
    got = s.read_region(0, 256, 256, 256, 256)
    s.close()
    params = extractive.fit(jnp.asarray(target), method="macenko")
    want = np.asarray(extractive.transform(
        params, jnp.asarray(lv0[256:512, 256:512][None])))[0]
    # Tile mode re-estimates per tile; estimating inside a batch of 4 vs a
    # 1-image call reassociates XLA reductions, moving a few pixels by up
    # to ~4 uint8 steps (the repo's documented cross-shape tolerance).
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 4 and (diff == 0).mean() > 0.99, (
        diff.max(), (diff == 0).mean())


@requires_native
def test_normalize_slide_reinhard(tmp_path):
    path, lv0 = _tissue_slide(tmp_path)
    out_path = str(tmp_path / "norm_r.tif")
    target = he_patch(256, 256, seed=42, stain=TGT_STAIN,
                      background_frac=0.0)
    info = normalize_slide(path, out_path, target, method="reinhard",
                           batch=4, n_fit_tiles=8, compression="deflate")
    assert info["method"] == "reinhard"
    s = native.TiffSlide(out_path)
    got = s.read_region(0, 0, 0, 600, 520)
    s.close()
    assert got.shape == (520, 600, 3)
    # The written tile equals the fixed-stats Reinhard transform applied
    # directly: every tile shares ONE slide-level affine (no per-tile
    # re-estimation), so adjacent tiles cannot disagree about color.
    from stainlib_tpu.normalization import reinhard
    from stainlib_tpu.normalization.slide import fit_slide_reinhard

    src = fit_slide_reinhard(path, n_tiles=8, seed=0)
    params = reinhard.fit(jnp.asarray(target))
    want = np.asarray(reinhard.transform(
        params, jnp.asarray(lv0[256:512, 256:512][None]),
        source_stats=src.stats,
        brightness_divisor=src.brightness_divisor))[0]
    diff = np.abs(got[256:512, 256:512].astype(int) - want.astype(int))
    assert diff.max() <= 4 and (diff == 0).mean() > 0.99, (
        diff.max(), (diff == 0).mean())


@requires_native
def test_normalize_slide_vahadane(tmp_path):
    path, lv0 = _tissue_slide(tmp_path)
    out_path = str(tmp_path / "norm_v.tif")
    target = he_patch(256, 256, seed=43, stain=TGT_STAIN,
                      background_frac=0.0)
    info = normalize_slide(path, out_path, target, method="vahadane",
                           estimation="slide", batch=4, n_fit_tiles=4,
                           compression="deflate")
    assert info["tiles"] == 9
    s = native.TiffSlide(out_path)
    got = s.read_region(0, 0, 0, 600, 520)
    s.close()
    assert got[:16].min() >= 250  # white margin preserved
    assert np.abs(got[200:400, 100:500].astype(int)
                  - lv0[200:400, 100:500].astype(int)).mean() > 2.0


@requires_native
def test_normalize_slide_wsiraw_input(tmp_path):
    """WSIRAW (mmap) slides lack the batched read_regions entry point; the
    driver's per-region fallback must still produce a correct slide."""
    path_raw = str(tmp_path / "t.wsiraw")
    tiles = he_batch(4, 256, 256, seed=9, background_frac=0.0)
    lv0 = np.concatenate(
        [np.concatenate(list(tiles[:2]), axis=1),
         np.concatenate(list(tiles[2:]), axis=1)], axis=0)
    native.write_wsiraw(path_raw, [lv0])
    out_path = str(tmp_path / "out.tif")
    target = he_patch(256, 256, seed=44, stain=TGT_STAIN,
                      background_frac=0.0)
    info = normalize_slide(path_raw, out_path, target, batch=4,
                           n_fit_tiles=4, compression="deflate")
    assert info["tiles"] == 4
    s = native.TiffSlide(out_path)
    got = s.read_region(0, 0, 0, 512, 512)
    s.close()
    assert np.abs(got.astype(int) - lv0.astype(int)).mean() > 2.0


def test_build_pyramid_levels():
    lv0 = (np.arange(1024 * 1024 * 3) % 255).astype(np.uint8).reshape(
        1024, 1024, 3)
    levels = build_pyramid(lv0, min_dim=128)
    assert [l.shape[0] for l in levels] == [1024, 512, 256, 128]
    # 2x box mean of the first block
    want = lv0[:2, :2].astype(int).mean((0, 1))
    np.testing.assert_allclose(levels[1][0, 0], np.round(want), atol=1.0)


def test_build_pyramid_chunked_matches_unchunked():
    """The row-chunked reduction (memmap-friendly) must equal the one-shot
    box mean, including odd-dimension cropping."""
    rng = np.random.default_rng(5)
    lv0 = rng.integers(0, 256, (257, 515, 3), np.uint8)
    got = build_pyramid(lv0, min_dim=64)
    h2, w2 = 128, 257
    c = lv0[: 2 * h2, : 2 * w2].astype(np.uint16)
    want = ((c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2]
             + c[1::2, 1::2] + 2) // 4).astype(np.uint8)
    assert (got[1] == want).all()


@requires_native
def test_normalize_slide_memmap_canvas_identical(tmp_path, monkeypatch):
    """Forcing the disk-backed canvas/pyramid path (tiny RAM threshold)
    and a batch that does not divide the tile count (padding path) must
    produce a byte-identical slide to the default in-RAM run."""
    from stainlib_tpu.normalization import slide as slide_mod

    path, _ = _tissue_slide(tmp_path)
    target = he_patch(256, 256, seed=44, stain=TGT_STAIN,
                      background_frac=0.0)
    out_a = str(tmp_path / "ram.tif")
    normalize_slide(path, out_a, target, method="macenko", batch=4,
                    n_fit_tiles=8, seed=3, compression="deflate")
    monkeypatch.setattr(slide_mod, "_RAM_CANVAS_BYTES", 1 << 10)
    out_b = str(tmp_path / "mmap.tif")
    normalize_slide(path, out_b, target, method="macenko", batch=4,
                    n_fit_tiles=8, seed=3, compression="deflate")
    sa, sb = native.TiffSlide(out_a), native.TiffSlide(out_b)
    a = sa.read_region(0, 0, 0, 600, 520)
    b = sb.read_region(0, 0, 0, 600, 520)
    sa.close(), sb.close()
    assert (a == b).all()


@requires_native
def test_normalize_slide_mesh_identical(tmp_path):
    """Mesh deployment: sharding the tile batches over a device mesh must
    produce a byte-identical slide to the single-device run (the per-rank
    deployment of ``train_img_horo.py:541-594`` over ``shard_map``)."""
    from stainlib_tpu.parallel.mesh import make_mesh

    path, _ = _tissue_slide(tmp_path)
    target = he_patch(256, 256, seed=45, stain=TGT_STAIN,
                      background_frac=0.0)
    out_a = str(tmp_path / "single.tif")
    normalize_slide(path, out_a, target, method="macenko", batch=8,
                    n_fit_tiles=8, seed=3, compression="deflate")
    mesh = make_mesh(4)
    out_b = str(tmp_path / "mesh.tif")
    info = normalize_slide(path, out_b, target, method="macenko", batch=8,
                           n_fit_tiles=8, seed=3, compression="deflate",
                           mesh=mesh)
    assert info["tiles"] == 9
    sa, sb = native.TiffSlide(out_a), native.TiffSlide(out_b)
    a = sa.read_region(0, 0, 0, 600, 520)
    b = sb.read_region(0, 0, 0, 600, 520)
    sa.close(), sb.close()
    assert (a == b).all()

    # Batch not divisible by the mesh size is rejected up front.
    with pytest.raises(ValueError, match="multiple of the mesh"):
        normalize_slide(path, str(tmp_path / "bad.tif"), target, batch=6,
                        mesh=mesh)

    # Multi-axis mesh: divisibility is against the SHARDED axis size (2),
    # not the total device count (4) — batch=2 is valid work split over
    # the 'data' axis and replicated across 'tiles'.
    mesh2 = make_mesh(4, data=2, tiles=2)
    out_c = str(tmp_path / "mesh2.tif")
    normalize_slide(path, out_c, target, method="macenko", batch=2,
                    n_fit_tiles=8, seed=3, compression="deflate",
                    mesh=mesh2)
    sc = native.TiffSlide(out_c)
    c = sc.read_region(0, 0, 0, 600, 520)
    sc.close()
    assert (a == c).all()
    with pytest.raises(ValueError, match="'data' axis size"):
        normalize_slide(path, str(tmp_path / "bad2.tif"), target, batch=3,
                        mesh=mesh2)
    with pytest.raises(ValueError, match="not in mesh axes"):
        normalize_slide(path, str(tmp_path / "bad3.tif"), target, batch=2,
                        mesh=mesh2, mesh_axis="nope")


def test_percentile_sequence_q_bisect_route():
    """Sequence q above the bisection threshold: q-leading stacking, same
    values as the sort route computes on smaller data."""
    from stainlib_tpu.ops.percentile import percentile

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 600_000)).astype(np.float32)
    got = np.asarray(percentile(x, [1.0, 50.0, 99.0], axis=-1))
    want = np.stack([np.percentile(x, q, axis=-1)
                     for q in (1.0, 50.0, 99.0)])
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, atol=2e-3)
