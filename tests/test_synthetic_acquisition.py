"""The non-Beer-Lambert ACQUISITION cohort (round 5).

The r4 analysis pinned the flow-vs-Macenko seg-transfer residual to the
synthetic cohort being Beer-Lambert BY CONSTRUCTION — the exact model class
Macenko inverts (near-oracle in scripts/seg_transfer_demo.py). The acquisition
cohort (`synthetic._ACQ_CENTERS`) models the regime the reference claims for
the learned flow — per-center scanner tone curves, chroma-dependent sensor
saturation, defocus, noise, JPEG (``dlmodels/color-information/README.md``:
normalizing "different stain procedures and scanner effects"). These tests
pin the properties the r5 seg-transfer experiment rests on:

  * the distortion is OUTSIDE the stain-matrix model class (the rank-2
    OD-plane structure Macenko estimates is measurably broken),
  * masks and the underlying tissue are bit-identical across cohorts (the
    labels stay a property of the tissue, not the scanner),
  * the generator is deterministic.
"""

import numpy as np
import pytest

from stainlib_tpu.data.synthetic import (
    N_CENTERS, center_tiles, center_tiles_with_masks, multi_center_batches,
)


def _od_rank_ratio(tiles, masks):
    """Third-vs-second singular value of the tissue-pixel OD matrix — ~0 for
    a 2-stain Beer-Lambert render (OD lies in the rank-2 span of the stain
    vectors, plus quantization), materially larger once the acquisition
    chain's non-log-linear steps are applied."""
    px = tiles[masks > 0]
    px = px[(px >= 10).all(-1)]  # avoid log-amplified quantization noise
    od = -np.log(px.astype(np.float64) / 255.0)
    s = np.linalg.svd(od, compute_uv=False)
    return float(s[2] / s[1])


def test_masks_and_tissue_identical_across_cohorts():
    for c in range(N_CENTERS):
        tb, mb = center_tiles_with_masks(c, 4, 48, 48, seed=3, cohort="bl")
        ta, ma = center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                         cohort="acquisition")
        np.testing.assert_array_equal(mb, ma)
        # ... while the rendered tiles differ materially.
        assert np.abs(tb.astype(int) - ta.astype(int)).mean() > 5.0


def test_acquisition_deterministic():
    a = center_tiles_with_masks(2, 3, 32, 32, seed=7, cohort="acquisition")
    b = center_tiles_with_masks(2, 3, 32, 32, seed=7, cohort="acquisition")
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    # center_tiles is the tiles half of center_tiles_with_masks.
    np.testing.assert_array_equal(
        center_tiles(2, 3, 32, 32, seed=7, cohort="acquisition"), a[0])


def test_acquisition_breaks_beer_lambert_rank2():
    # Measured at pin time (64^2, seed 3): bl ratios 0.01-0.11, acquisition
    # 0.10-0.45, per-center acq/bl ratio >= 2.7x.
    for c in range(N_CENTERS):
        tb, mb = center_tiles_with_masks(c, 8, 64, 64, seed=3, cohort="bl")
        ta, ma = center_tiles_with_masks(c, 8, 64, 64, seed=3,
                                         cohort="acquisition")
        rb, ra = _od_rank_ratio(tb, mb), _od_rank_ratio(ta, ma)
        assert ra > 2.0 * rb, (c, rb, ra)
        assert rb < 0.15, (c, rb)  # the BL cohort really is near rank-2


def test_acquisition_clean_drops_degradation_keeps_color():
    """'acquisition-clean' (the r5 mechanism probe) keeps the tone-curve /
    saturation COLOR distortion but removes the information-destroying
    stages: masks identical, tiles still far from the bl render, and the
    template center (whose acquisition chain is only noise+JPEG) becomes
    bit-near the clean Beer-Lambert render."""
    for c in range(N_CENTERS):
        ta, ma = center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                         cohort="acquisition")
        tc, mc = center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                         cohort="acquisition-clean")
        np.testing.assert_array_equal(ma, mc)
        # Every center keeps its color distortion (the g=k=1 filmic of the
        # template center is y = 2x/(x+1), itself a real tone curve)...
        tb, _ = center_tiles_with_masks(c, 4, 48, 48, seed=3, cohort="bl")
        assert np.abs(tb.astype(int) - tc.astype(int)).mean() > 5.0
        # ...and sheds the degradation stages (noise/JPEG move pixels on
        # every _ACQ_CENTERS entry).
        assert np.abs(ta.astype(int) - tc.astype(int)).mean() > 0.3
        # The clean chain stays deterministic (no noise draws consumed).
        t2, _ = center_tiles_with_masks(c, 4, 48, 48, seed=3,
                                        cohort="acquisition-clean")
        np.testing.assert_array_equal(tc, t2)


def test_unknown_cohort_rejected():
    with pytest.raises(ValueError, match="cohort"):
        center_tiles_with_masks(0, 1, 16, 16, cohort="nope")


def test_multi_center_batches_cohort_plumbed():
    bat, labels = multi_center_batches(range(2), 4, 4, 32, 32, seed=1,
                                       cohort="acquisition")
    assert bat[0].dtype == np.uint8 and bat[0].shape == (4, 32, 32, 3)
    # Same call on the bl cohort yields different pixels.
    bat_bl, _ = multi_center_batches(range(2), 4, 4, 32, 32, seed=1)
    assert any(not np.array_equal(a, b) for a, b in zip(bat, bat_bl))
