"""Downstream segmentation transfer: normalization must close the
cross-center mIoU gap (the shape of the reference's "Semantic Segmentation
Comparison" table, ``dlmodels/color-information/README.md`` — segmenter
trained on one center, deployed on color-shifted inputs)."""

import numpy as np
import pytest


def test_masks_are_center_invariant_and_tiles_unchanged():
    from stainlib_tpu.data.synthetic import (
        N_SEG_CLASSES, center_tiles, center_tiles_with_masks,
    )

    tiles, masks = center_tiles_with_masks(0, 4, 32, 32, seed=5)
    assert tiles.shape == (4, 32, 32, 3) and masks.shape == (4, 32, 32)
    assert masks.min() >= 0 and masks.max() < N_SEG_CLASSES
    # Mask derivation consumes no RNG draws: tiles stay bit-identical to
    # the plain generator (the NMI demos' recorded numbers depend on it).
    assert (center_tiles(0, 4, 32, 32, seed=5) == tiles).all()
    # Every class present in a reasonable proportion.
    fracs = [(masks == k).mean() for k in range(N_SEG_CLASSES)]
    assert all(f > 0.05 for f in fracs), fracs
    # The whitespace band rows are background.
    assert (masks[:, :4] == 0).all()


def test_mean_iou_metric():
    from stainlib_tpu.models.segmentation import mean_iou

    a = np.array([[0, 0, 1, 1]])
    assert mean_iou(a, a, 3) == 1.0
    b = np.array([[0, 1, 1, 1]])  # class0: inter 1 union 2; class1: 2/3
    assert abs(mean_iou(b, a, 3) - (0.5 + 2 / 3) / 2) < 1e-9
    # Classes absent from the labels are skipped, not counted as 0.
    assert mean_iou(np.zeros((2, 2)), np.zeros((2, 2)), 3) == 1.0


def test_unet_shapes():
    import jax
    import jax.numpy as jnp

    from stainlib_tpu.models.segmentation import UNet

    m = UNet(n_classes=3, base=4, depth=2)
    params = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))
    out = m.apply(params, jnp.zeros((2, 16, 16, 3)))
    assert out.shape == (2, 16, 16, 3)


@pytest.mark.slow
def test_normalization_closes_cross_center_miou_gap(tmp_path):
    import sys

    sys.path.insert(0, "scripts")
    from seg_transfer_demo import parse_args, run

    args = parse_args([
        "--size", "32", "--train-tiles", "48", "--eval-tiles", "12",
        "--seg-steps", "120", "--seg-base", "8", "--methods", "raw,macenko",
        "--out", str(tmp_path),
    ])
    s = run(args)["conditions"]
    # Trained on the template center, a raw-input segmenter works there...
    assert s["raw"]["template_miou"] > 0.6, s
    # ...and degrades badly on the stain-shifted centers (measured ~0.38
    # at this scale), while Macenko-normalized inputs transfer (~0.7).
    assert (s["macenko"]["shifted_mean_miou"]
            > s["raw"]["shifted_mean_miou"] + 0.1), s
    assert s["macenko"]["shifted_mean_miou"] > 0.55, s


@pytest.mark.slow
def test_seg_demo_flow_center_scope_class_match(tmp_path):
    """--class-match --class-match-scope center: the flow condition pools
    usage per center (ONE perm, the slide-level granularity) and the demo runs end to end with the quantile transfer."""
    import sys

    sys.path.insert(0, "scripts")
    from seg_transfer_demo import parse_args, run

    args = parse_args([
        "--size", "32", "--train-tiles", "24", "--eval-tiles", "8",
        "--seg-steps", "40", "--seg-base", "4", "--seg-depth", "2",
        "--methods", "flow", "--flow-steps", "30", "--flow-hidden", "8",
        "--flow-scales", "1", "--flow-blocks", "1", "--flow-clusters", "3",
        "--class-match", "--class-match-scope", "center",
        "--transfer", "quantile", "--out", str(tmp_path),
    ])
    s = run(args)["conditions"]
    assert "flow" in s and len(s["flow"]["per_center"]) == 5
    assert all(0.0 <= v <= 1.0 for v in s["flow"]["per_center"])
