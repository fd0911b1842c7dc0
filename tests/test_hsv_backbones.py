"""HSV jitter + DANN variant backbones."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from stainlib_tpu.augmentation.hsv import (
    hsv_jitter,
    hsv_light,
    hsv_strong,
    hsv_to_rgb,
    rgb_to_hsv,
)
from stainlib_tpu.models.backbones import DannCNNGap, MobileNetDann
from tests.synth import he_batch, he_patch

KEY = jax.random.PRNGKey(0)


def test_hsv_round_trip():
    rng = np.random.default_rng(0)
    x = rng.random((4, 8, 8, 3)).astype(np.float32)
    back = np.asarray(hsv_to_rgb(rgb_to_hsv(jnp.asarray(x))))
    np.testing.assert_allclose(back, x, atol=1e-5)


def test_hsv_jitter_shapes_and_zero_identity():
    batch = jnp.asarray(he_batch(2, 16, 16, seed=100))
    out = np.asarray(hsv_jitter(batch, KEY, 0.0, 0.0, 0.0))
    assert np.abs(out.astype(int) - np.asarray(batch).astype(int)).max() <= 1
    jit1 = np.asarray(hsv_light(batch, KEY))
    jit2 = np.asarray(hsv_strong(batch, KEY))
    assert jit1.shape == (2, 16, 16, 3)
    assert (jit1 != np.asarray(batch)).any()
    # strong moves further than light on average
    d1 = np.abs(jit1.astype(int) - np.asarray(batch).astype(int)).mean()
    d2 = np.abs(jit2.astype(int) - np.asarray(batch).astype(int)).mean()
    assert d2 > d1


def test_dann_gap_variant():
    model = DannCNNGap(n_domains=4, dropout=0.0)
    x = jnp.zeros((2, 63, 63, 3), jnp.float32)
    vars_ = model.init(KEY, x, train=False)
    (mit, dom), = [model.apply(vars_, x, train=False)]
    assert mit.shape == (2, 2) and dom.shape == (2, 4)


@pytest.mark.slow
def test_mobilenet_dann_224():
    model = MobileNetDann(n_domains=5, alpha=0.5)
    x = jnp.zeros((1, 224, 224, 3), jnp.float32)
    vars_ = model.init(KEY, x, train=False)
    mit, dom = model.apply(vars_, x, train=False)
    assert mit.shape == (1, 2) and dom.shape == (1, 5)
    # Trunk parity with the reference backbone (tcga_dann_4reps.py:75):
    # keras MobileNet(alpha=0.5, include_top=False) reports Total params
    # 829,536 (trainable + BN moving stats). Ours must match exactly.
    from stainlib_tpu.models.backbones import MobileNetBackbone
    tv = MobileNetBackbone(alpha=0.5).init(KEY, x, train=False)
    n_trunk = sum(p.size for p in jax.tree.leaves(tv["params"]))
    n_stats = sum(p.size for p in jax.tree.leaves(tv["batch_stats"]))
    assert n_trunk + n_stats == 829_536, (n_trunk, n_stats)


@pytest.mark.slow
def test_mobilenet_dann_trains_three_phases():
    """MobileNetDann under the generic 3-phase step (the capacity driver's
    loop, scripts/train_dann_capacity.py; ref tcga_dann_4reps.py:140-168):
    batch-stats + gradient-reversal plumbing work for this model class and
    all three phase weightings run on ONE compiled function."""
    import functools
    import optax
    from stainlib_tpu.data.synthetic import two_domain_task
    from stainlib_tpu.models import dann

    model = MobileNetDann(n_domains=2, alpha=0.25)
    X, y, d = two_domain_task(16, seed=0, size=32, correlation=0.5)
    X, y, d = jnp.asarray(X), jnp.asarray(y), jnp.asarray(d)
    variables = model.init(KEY, X[:1], train=False)
    tx = optax.adam(1e-3)
    state = dann.DannState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]), key=KEY,
    )
    step = jax.jit(functools.partial(dann.dann_train_step, model, tx))
    losses = []
    for ph in (dann.PHASE_MITOSIS, dann.PHASE_DOMAIN,
               dann.PHASE_ADVERSARIAL):
        state, out = step(state, X, y, d, *ph)
        losses.append(float(out["loss"]))
    assert all(np.isfinite(l) for l in losses), losses
    # second sweep reuses the same compiled fn (traced scalar weights)
    n0 = step._cache_size() if hasattr(step, "_cache_size") else None
    for ph in (dann.PHASE_MITOSIS, dann.PHASE_DOMAIN,
               dann.PHASE_ADVERSARIAL):
        state, out = step(state, X, y, d, *ph)
    if n0 is not None:
        assert step._cache_size() == n0


def test_stain_domain_task_semantics():
    """stain_domain_task: hue-recipe domains at matched brightness, stripe
    orientation in the H-concentration field (the capacity-DANN cue;
    scripts/train_dann_capacity.py motivates it)."""
    from stainlib_tpu.data.synthetic import stain_domain_task

    X, y, d = stain_domain_task(8, seed=0, size=32, correlation=0.5)
    assert X.shape == (8, 32, 32, 3) and X.dtype == np.float32
    assert X.min() >= 0.0 and X.max() <= 1.0
    assert set(np.unique(y)) <= {0, 1} and set(np.unique(d)) <= {0, 1}
    # determinism
    X2, y2, d2 = stain_domain_task(8, seed=0, size=32, correlation=0.5)
    np.testing.assert_array_equal(X, X2)
    np.testing.assert_array_equal(y, y2)
    # matched brightness: mean luminance gap between domains is small
    # relative to the tint task's deliberate gap
    lum = X.mean(axis=(1, 2, 3))
    g0, g1 = lum[d == 0], lum[d == 1]
    if g0.size and g1.size:
        assert abs(g0.mean() - g1.mean()) < 0.08
    # full correlation control
    _, y3, d3 = stain_domain_task(16, seed=1, size=16, correlation=1.0)
    np.testing.assert_array_equal(y3, d3)
