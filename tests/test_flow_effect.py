"""The flow+GMM normalizer must actually NORMALIZE.

Synthetic multi-center cohort with a deliberately large inter-center stain
shift (raw NMI SD ~0.11-0.14, vs the published normalized level 0.038 —
README NMI tables); after train + ``image_dist_transform`` the NMI SD/CV
must drop by a large factor (``train_img_horo.py:658-930``).
"""

import numpy as np
import pytest


@pytest.mark.slow
def test_flow_normalization_reduces_nmi_spread(tmp_path):
    import sys

    sys.path.insert(0, "scripts")
    from flow_effect_demo import parse_args, run

    args = parse_args([
        "--steps", "20", "--image-size", "16", "--batch", "16",
        "--hidden", "16", "--n-scales", "1", "--tiles-per-center", "8",
        "--out", str(tmp_path),
    ])
    s = run(args)
    assert s["raw_nmi_sd"] > 0.08, s  # the cohort really is shifted
    assert s["normalized_nmi_sd"] < s["raw_nmi_sd"] / 1.5, s
    assert s["normalized_nmi_cv"] < s["raw_nmi_cv"] / 1.5, s


def test_two_domain_task_shapes_and_cue():
    from stainlib_tpu.data.synthetic import two_domain_task

    x, y, d = two_domain_task(64, seed=1, correlation=1.0)
    assert x.shape == (64, 63, 63, 3) and x.dtype == np.float32
    assert (y == d).all()  # correlation=1: tint always matches the task
    x2, y2, d2 = two_domain_task(64, seed=2, correlation=0.0)
    assert (y2 != d2).all()
    # The tint is a real, detectable cue: red channel mean separates domains.
    red = x2[..., 0].mean((1, 2))
    blue = x2[..., 2].mean((1, 2))
    assert ((red > blue) == (d2 == 0)).mean() > 0.95
