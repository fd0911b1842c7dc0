"""Fidelity contract: the jnp path's output vs the independent CPU golden.

The contract: "mean delta-E < 1.0 vs CPU stainlib on identical inputs". The
CPU golden here recomputes the whole pipeline with numpy/OpenCV/scipy
(tests/cpu_reference.py) — no shared code with the device path.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stainlib_tpu.normalization import extractive, reinhard
from tests import cpu_reference as ref
from tests.synth import he_patch


@pytest.mark.slow
def test_fused_macenko_delta_e_vs_cpu_golden():
    target = he_patch(48, 64, seed=120)
    src = he_patch(48, 64, seed=121)

    params = extractive.fit(jnp.asarray(target), method="macenko")
    got = np.asarray(extractive.transform_jit(params, jnp.asarray(src)))

    Mt = ref.macenko_stain_matrix(target)
    Ct = ref.nonneg_lasso(ref.rgb_to_od(target).reshape(-1, 3), Mt)
    maxC_t = np.percentile(Ct, 99, axis=0)
    Ms = ref.macenko_stain_matrix(src)
    Cs = ref.nonneg_lasso(ref.rgb_to_od(src).reshape(-1, 3), Ms)
    maxC_s = np.percentile(Cs, 99, axis=0)
    want = ref.reconstruct(Cs * (maxC_t / maxC_s), Mt, src.shape)

    de = ref.delta_e(got, want)
    assert de < 1.0, de


def test_fused_reinhard_delta_e_vs_cpu_golden():
    target = he_patch(64, 64, seed=122)
    src = he_patch(64, 64, seed=123)
    params = reinhard.fit(jnp.asarray(target))
    got = np.asarray(reinhard.transform_jit(params, jnp.asarray(src)))
    t_means, t_stds = ref.reinhard_fit(target)
    want = ref.reinhard_transform(src, t_means, t_stds)
    de = ref.delta_e(got, want)
    assert de < 1.0, de


@pytest.mark.slow
def test_fused_vahadane_delta_e_vs_cpu_golden():
    """Independent Vahadane anchor: the jnp path vs a sklearn positive
    dictionary learner + scipy-QP lasso golden that shares no code with the
    device solver (vahadane_stain_extractor.py:19-43)."""
    target = he_patch(48, 64, seed=124)
    src = he_patch(48, 64, seed=125)

    params = extractive.fit(jnp.asarray(target), method="vahadane")
    got = np.asarray(extractive.transform_jit(params, jnp.asarray(src),
                                              method="vahadane"))

    Mt = ref.vahadane_stain_matrix(target)
    Ct = ref.nonneg_lasso(ref.rgb_to_od(target).reshape(-1, 3), Mt)
    maxC_t = np.percentile(Ct, 99, axis=0)
    Ms = ref.vahadane_stain_matrix(src)
    Cs = ref.nonneg_lasso(ref.rgb_to_od(src).reshape(-1, 3), Ms)
    maxC_s = np.percentile(Cs, 99, axis=0)
    want = ref.reconstruct(Cs * (maxC_t / maxC_s), Mt, src.shape)

    de = ref.delta_e(got, want)
    assert de < 1.0, de


@pytest.mark.slow
def test_vahadane_stain_matrix_vs_sklearn_golden():
    """The BCD dictionary itself lands near the sklearn optimum (cosine
    similarity per stain row) — anchors the matrix, not just the pixels."""
    from stainlib_tpu.extraction.vahadane import stain_matrix_vahadane

    img = he_patch(48, 64, seed=126)
    got = np.asarray(stain_matrix_vahadane(jnp.asarray(img)[None]))[0]
    want = ref.vahadane_stain_matrix(img)
    cos = (got * want).sum(-1)  # both row-normalized
    assert (cos > 0.999).all(), (cos, got, want)
