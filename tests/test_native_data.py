"""Native C++ tile pipeline vs numpy fallbacks and reference semantics."""

import numpy as np
import pytest

from stainlib_tpu.data import native
from tests.synth import he_patch


@pytest.fixture(scope="module")
def slide_path(tmp_path_factory):
    """A two-level synthetic pyramid: tissue in the center, white border."""
    rng = np.random.default_rng(0)
    lv0 = np.full((256, 320, 3), 255, np.uint8)
    lv0[64:192, 80:240] = he_patch(128, 160, seed=1, background_frac=0.0)
    lv1 = lv0[::2, ::2].copy()
    path = tmp_path_factory.mktemp("wsi") / "slide.wsr"
    native.write_wsiraw(str(path), [lv0, lv1])
    return str(path), lv0, lv1


def test_native_builds():
    assert native.build_native() is not None
    assert native.native_available()


def test_open_and_geometry(slide_path):
    path, lv0, lv1 = slide_path
    s = native.RawSlide(path)
    assert s.native
    assert s.num_levels == 2
    assert s.level_size(0) == (320, 256)
    assert s.level_size(1) == (160, 128)
    s.close()


def test_read_region_matches_numpy(slide_path):
    path, lv0, _ = slide_path
    s = native.RawSlide(path)
    region = s.read_region(0, 100, 70, 64, 48)
    np.testing.assert_array_equal(region, lv0[70:118, 100:164])
    # Out-of-bounds is white-filled.
    edge = s.read_region(0, -8, -8, 16, 16)
    assert (edge[:8, :8] == 255).all()
    np.testing.assert_array_equal(edge[8:, 8:], lv0[:8, :8])
    s.close()


def test_sample_tiles_rejects_background(slide_path):
    path, lv0, _ = slide_path
    s = native.RawSlide(path)
    tiles, coords = s.sample_tiles(0, tile=32, n=16, seed=7)
    ok = coords[:, 0] >= 0
    assert ok.sum() >= 12  # plenty of tissue available
    means = tiles[ok].reshape(ok.sum(), -1).mean(1)
    stds = tiles[ok].reshape(ok.sum(), -1).std(1)
    assert (means <= 230.0).all()
    assert (stds >= 15.0).all()
    # Deterministic under the same seed.
    tiles2, coords2 = s.sample_tiles(0, tile=32, n=16, seed=7)
    np.testing.assert_array_equal(coords, coords2)
    s.close()


def test_sample_tiles_respects_mask(slide_path):
    path, lv0, _ = slide_path
    s = native.RawSlide(path)
    mask = np.zeros((256, 320), np.uint8)
    mask[64:160, 80:160] = 1  # only the left part of the tissue
    tiles, coords = s.sample_tiles(0, tile=32, n=8, seed=3, mask=mask,
                                   mask_scale=1.0)
    ok = coords[:, 0] >= 0
    assert ok.any()
    assert (mask[coords[ok, 1], coords[ok, 0]] == 1).all()
    s.close()


def test_tissue_mask_hsv_finds_tissue(slide_path):
    _, lv0, _ = slide_path
    # H&E tissue is pinkish/purple: hue wraps near 140-180 in cv2 convention.
    mask = native.tissue_mask_hsv(lv0, h_range=(0, 180), s_range=(20, 255),
                                  v_range=(30, 255), k_close=9, k_open=7)
    inside = mask[80:180, 96:224].mean()
    outside = mask[:50].mean()
    assert inside > 0.8 and outside < 0.05, (inside, outside)


def test_numpy_fallback_paths(slide_path, monkeypatch):
    path, lv0, _ = slide_path
    monkeypatch.setattr(native, "get_lib", lambda: None)
    s = native.RawSlide(path)
    assert not s.native
    region = s.read_region(0, 100, 70, 64, 48)
    np.testing.assert_array_equal(region, lv0[70:118, 100:164])
    tiles, coords = s.sample_tiles(0, tile=32, n=4, seed=5)
    ok = coords[:, 0] >= 0
    assert ok.any()


def test_level_out_of_range_raises(slide_path):
    path, _, _ = slide_path
    s = native.RawSlide(path)
    try:
        with pytest.raises(IndexError):
            s.level_size(5)
        with pytest.raises(IndexError):
            s.read_region(5, 0, 0, 16, 16)
        with pytest.raises(IndexError):
            s.sample_tiles(-1, 16, 2)
    finally:
        s.close()


def test_sample_tiles_level_smaller_than_tile(slide_path):
    """Level smaller than the tile: the documented gray/(-1,-1) contract,
    never uninitialized memory (native early-returns without writing)."""
    path, _, _ = slide_path
    s = native.RawSlide(path)
    try:
        tiles, coords = s.sample_tiles(1, 512, 3, seed=1)  # lv1 is 160x128
        assert (coords == -1).all()
        assert (tiles == 128).all()
    finally:
        s.close()


def test_corrupt_wsiraw_header_rejected(tmp_path):
    """Overflowing w*h in the header must not pass tr_open's size check
    (3*w*h wrapping uint64) — expect a clean Python error, not a crash."""
    path = str(tmp_path / "evil.wsr")
    with open(path, "wb") as f:
        f.write(np.uint32(native.MAGIC).tobytes())
        f.write(np.uint32(1).tobytes())
        f.write(np.uint32(0x80000000).tobytes())  # w
        f.write(np.uint32(0x80000000).tobytes())  # h: 3*w*h wraps mod 2^64
        f.write(np.zeros(2, np.uint32).tobytes())
        f.write(b"\x00" * 64)
    with pytest.raises(Exception):
        native.RawSlide(path)  # native open refuses -> numpy fallback raises
