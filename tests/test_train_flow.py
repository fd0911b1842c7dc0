"""Flow trainer: EMA, checkpoint round trip, bpd descent, sharded step,
template transfer + NMI metrics."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stainlib_tpu.models import color_eval, validate_flow
from stainlib_tpu.models.train_flow import (
    FlowConfig,
    build_models,
    encode,
    init_flow_state,
    make_train_step,
)
from stainlib_tpu.ops.colorspace import rgb_to_hsd
from stainlib_tpu.parallel.mesh import make_mesh
from stainlib_tpu.utils import checkpoint as ckpt
from stainlib_tpu.utils.ema import ema_init, ema_update
from tests.synth import he_batch

KEY = jax.random.PRNGKey(0)
CFG = FlowConfig(image_size=16, n_scales=1, blocks_per_scale=2, hidden=8,
                 n_power_series=3, n_clusters=3, lr=5e-3, warmup_iters=5,
                 ema_decay=0.5)


def _hsd_batch(n=8, seed=0):
    rgb = he_batch(n, 16, 16, seed=seed, background_frac=0.0)
    return jnp.asarray(rgb_to_hsd(jnp.asarray(rgb)))


def test_ema_math():
    p = {"w": jnp.zeros((2,))}
    st = ema_init(p, decay=0.9)
    st = ema_update(st, {"w": jnp.ones((2,))})
    np.testing.assert_allclose(np.asarray(st.params["w"]), 0.1, rtol=1e-6)


def test_checkpoint_round_trip(tmp_path):
    state = {"a": jnp.arange(3, dtype=jnp.float32), "b": {"c": jnp.ones((2, 2))}}
    d = str(tmp_path)
    for step in range(7):
        ckpt.save_checkpoint(d, state, step, keep_last=3)
    # Rotation kept only the last 3 numbered checkpoints.
    assert ckpt.latest_step(d) == 6
    import os

    numbered = [p for p in os.listdir(d) if p != "ckpt_most_recent.msgpack"]
    assert len(numbered) == 3
    restored = ckpt.restore_checkpoint(d, state)
    np.testing.assert_allclose(np.asarray(restored["a"]), [0, 1, 2])


@pytest.mark.slow
def test_flow_training_reduces_bpd():
    batch = _hsd_batch(8, seed=1)
    flow, gmm, state, tx = init_flow_state(CFG, KEY, sample_hsd=batch)
    step = make_train_step(flow, gmm, CFG, tx)
    losses = []
    for i in range(30):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses[:3] + losses[-3:]


def test_flow_train_step_sharded():
    if jax.device_count() < 8:
        pytest.skip("needs 8 simulated devices")
    mesh = make_mesh(8, data=8)
    flow, gmm, state, tx = init_flow_state(CFG, KEY)
    step = make_train_step(flow, gmm, CFG, tx, mesh=mesh)
    batch = _hsd_batch(16, seed=2)
    state, loss = step(state, batch)
    assert np.isfinite(float(loss))
    # EMA and spectral state advanced.
    assert int(state.step) == 1


def test_encode_and_template_transfer_pipeline():
    flow, gmm, state, tx = init_flow_state(CFG, KEY)
    tmpl = _hsd_batch(4, seed=3)
    test = _hsd_batch(4, seed=4)
    bpd, z, gamma_t = encode(flow, gmm, state.params, state.spectral, CFG,
                             tmpl, KEY)
    assert bpd.shape == (4,) and gamma_t.shape[:3] == (4, 16, 16)

    mu_t, sd_t = color_eval.class_color_stats(tmpl, gamma_t)
    _, _, gamma_s = encode(flow, gmm, state.params, state.spectral, CFG,
                           test, KEY)
    mu_s, sd_s = color_eval.class_color_stats(test, gamma_s)
    out = color_eval.image_dist_transform(test, gamma_s, mu_s, sd_s, mu_t, sd_t)
    assert out.shape == (4, 16, 16, 3) and out.dtype == jnp.uint8

    # Identity transfer (template == source stats) reproduces the input.
    ident = color_eval.image_dist_transform(test, gamma_s, mu_s, sd_s,
                                            mu_s, sd_s)
    from stainlib_tpu.ops.colorspace import hsd_to_rgb, to_uint8

    direct = to_uint8(hsd_to_rgb(test))
    diff = np.abs(np.asarray(ident, int) - np.asarray(direct, int))
    assert diff.max() <= 1


def test_class_match_undoes_permutation():
    """Usage-rank matching recovers the k->k transfer under a synthetic GMM
    class relabelling — the measured OOD failure mechanism (scripts/seg_transfer_demo.py:
    the dominant tissue lands on a different cluster index on shifted
    centers, so the reference's unconditional k->k map recolors it with
    minority-class template statistics)."""
    rng = np.random.default_rng(0)
    K = 4
    # A sharply-assigned gamma with distinct class usage shares.
    cls = rng.choice(K, size=(2, 16, 16), p=[0.55, 0.25, 0.15, 0.05])
    gamma = np.eye(K, dtype=np.float32)[cls]
    hsd = rng.random((2, 16, 16, 3), np.float32)
    mu_t = rng.random((K, 3), np.float32)
    sd_t = 0.5 + 0.5 * rng.random((K, 3), np.float32)
    usage_t = np.asarray(color_eval.class_usage(gamma))
    mu_s, sd_s = color_eval.class_color_stats(hsd, gamma)
    want = color_eval.image_dist_transform(hsd, gamma, mu_s, sd_s, mu_t, sd_t)

    # Relabel the source classes by a permutation sigma: class k becomes
    # sigma[k]. Identity mapping now pairs wrong classes; usage matching
    # must recover sigma and reproduce the unpermuted output exactly.
    sigma = np.array([2, 0, 3, 1])
    gamma_p = gamma[..., np.argsort(sigma)]
    usage_p = np.asarray(color_eval.class_usage(gamma_p))
    perm = np.asarray(color_eval.match_classes_by_usage(usage_p, usage_t))
    assert np.array_equal(perm, np.argsort(sigma))
    mu_sp, sd_sp = color_eval.class_color_stats(hsd, gamma_p)
    got = color_eval.image_dist_transform(hsd, gamma_p, mu_sp, sd_sp,
                                          mu_t, sd_t, perm=perm)
    assert np.array_equal(np.asarray(got), np.asarray(want))

    # And on usage-consistent data the match is the identity: the
    # reference's k->k semantics are preserved bit-exactly.
    perm_id = np.asarray(color_eval.match_classes_by_usage(
        np.asarray(color_eval.class_usage(gamma)), usage_t))
    assert np.array_equal(perm_id, np.arange(K))


def test_monge_transfer_full_covariance():
    """Full-covariance per-class transfer (EXTENSION over the reference's
    diagonal (mu, sigma) affine at ``train_img_horo.py:815``): the Monge
    map satisfies A S A^T = T — it matches the template's chroma ROTATION,
    which no diagonal scaling can — and reduces exactly to the reference
    transfer when both covariances are diagonal."""
    rng = np.random.default_rng(0)
    K = 4

    def spd(k, scale=1.0):
        a = rng.normal(size=(k, 3, 3)) * scale
        return (np.einsum("kij,klj->kil", a, a)
                + 0.05 * np.eye(3)).astype(np.float32)

    S, T = spd(K), spd(K)
    A = np.asarray(color_eval.monge_maps(S, T))
    push = np.einsum("kij,kjl,kml->kim", A, S, A)
    assert np.abs(push - T).max() < 1e-4
    # SPD maps: symmetric, positive eigenvalues.
    assert np.abs(A - np.transpose(A, (0, 2, 1))).max() < 1e-5
    assert np.linalg.eigvalsh(A).min() > 0

    # Diagonal covariances: full transfer == the reference's diagonal one.
    cls = rng.choice(K, size=(2, 16, 16))
    gamma = np.eye(K, dtype=np.float32)[cls]
    hsd = rng.random((2, 16, 16, 3), np.float32)
    mu_s = rng.random((K, 3), np.float32)
    mu_t = rng.random((K, 3), np.float32)
    sd_s = 0.3 + 0.5 * rng.random((K, 3), np.float32)
    sd_t = 0.3 + 0.5 * rng.random((K, 3), np.float32)
    diag = color_eval.image_dist_transform(hsd, gamma, mu_s, sd_s,
                                           mu_t, sd_t)
    cov_s = np.stack([np.diag(s * s) for s in sd_s])
    cov_t = np.stack([np.diag(t * t) for t in sd_t])
    full = color_eval.image_dist_transform_full(hsd, gamma, mu_s, cov_s,
                                                mu_t, cov_t)
    diff = np.abs(np.asarray(diag, int) - np.asarray(full, int))
    assert diff.max() <= 1, diff.max()


def test_class_color_cov_consistent_with_stats():
    """class_color_cov's diagonal agrees with class_color_stats' sigma^2
    (same responsibilities, same weighting)."""
    rng = np.random.default_rng(1)
    gamma = rng.dirichlet(np.ones(3), size=(2, 8, 8)).astype(np.float32)
    hsd = rng.random((2, 8, 8, 3), np.float32)
    mu_a, sd = color_eval.class_color_stats(hsd, gamma)
    mu_b, cov = color_eval.class_color_cov(hsd, gamma)
    assert np.allclose(mu_a, mu_b, atol=1e-6)
    var = np.einsum("kcc->kc", np.asarray(cov))
    assert np.allclose(var, np.asarray(sd) ** 2, atol=1e-5)
    # PSD with the jitter in place.
    assert np.linalg.eigvalsh(np.asarray(cov)).min() > 0


def test_quantile_transfer_closes_nonaffine_shift():
    """Per-class quantile matching (EXTENSION) recovers the template
    distribution under a NON-AFFINE source shift — the failure mode the r4
    probe measured (Q-Q affine residual up to 0.91 of template spread) that
    bounds both the reference's diagonal transfer and the Monge maps."""
    rng = np.random.default_rng(3)
    K = 2
    cls_t = rng.choice(K, size=(2, 32, 32))
    g_t = np.eye(K, dtype=np.float32)[cls_t]
    x_t = np.where(cls_t[..., None] == 0,
                   rng.normal(0.3, 0.05, (2, 32, 32, 3)),
                   rng.normal(0.7, 0.10, (2, 32, 32, 3))).astype(np.float32)
    q_t, mass = color_eval.class_channel_quantiles(x_t, g_t)
    assert np.asarray(q_t).shape == (K, 3, 33)
    # Curves are monotone non-decreasing in p.
    assert (np.diff(np.asarray(q_t), axis=-1) >= -1e-6).all()

    # Source: the same class structure pushed through a nonlinear map.
    cls_s = rng.choice(K, size=(2, 32, 32))
    g_s = np.eye(K, dtype=np.float32)[cls_s]
    base = np.where(cls_s[..., None] == 0,
                    rng.normal(0.3, 0.05, (2, 32, 32, 3)),
                    rng.normal(0.7, 0.10, (2, 32, 32, 3)))
    x_s = (base ** 2 + 0.1).astype(np.float32)
    q_s, _ = color_eval.class_channel_quantiles(x_s, g_s)

    # Check the mapped HSD distribution per class (before RGB quantization)
    # matches the template's to a few percent at every decile.
    mapped = jax.vmap(lambda qs, qt: jax.vmap(
        lambda a, b, xc: jnp.interp(xc, a, b),
        in_axes=(0, 0, -1), out_axes=-1)(qs, qt, jnp.asarray(x_s)))(
            jnp.asarray(q_s), jnp.asarray(q_t))
    out = np.einsum("bhwk,kbhwc->bhwc", g_s, np.asarray(mapped))
    for k in range(K):
        got = out[cls_s == k].ravel()
        want = x_t[cls_t == k].ravel()
        deciles = [10, 30, 50, 70, 90]
        err = np.abs(np.percentile(got, deciles)
                     - np.percentile(want, deciles)).max()
        assert err < 0.03, (k, err)

    # The uint8 deployment entry point runs and returns the right shape.
    rgb = color_eval.image_dist_transform_quantile(x_s, g_s, q_s, q_t)
    assert rgb.shape == (2, 32, 32, 3) and rgb.dtype == jnp.uint8

    # Template == source stats -> identity map (round-trip within 1 u8).
    ident = color_eval.image_dist_transform_quantile(x_t, g_t, q_t, q_t)
    from stainlib_tpu.ops.colorspace import hsd_to_rgb, to_uint8

    direct = to_uint8(hsd_to_rgb(x_t))
    assert np.abs(np.asarray(ident, int) - np.asarray(direct, int)).max() <= 1


def test_rgb_quantile_transfer_inverts_tone_curve():
    """RGB-space quantile matching (EXTENSION, r5) inverts a per-RGB-channel
    monotone scanner tone curve EXACTLY (<= 1 u8), while the HSD-space
    matching cannot: the filmic curve of the acquisition cohort
    (``data/synthetic.py::_filmic``) is separable per RGB channel but
    non-separable after the HSD mix (measured here: >10 u8 residual)."""
    from stainlib_tpu.ops.colorspace import rgb_to_hsd

    rng = np.random.default_rng(7)
    tmpl = rng.uniform(40, 230, (2, 32, 32, 3)).astype(np.float32)

    def filmic(x, g, k):
        xg = np.power(x / 255.0, g)
        return 255.0 * (1 + k) * xg / (xg + k)

    src = filmic(tmpl, np.array([0.7, 0.85, 1.2]),
                 np.array([0.7, 0.9, 1.3])).astype(np.float32)
    K = 4
    gamma = rng.dirichlet(np.ones(K), size=(2, 32, 32)).astype(np.float32)

    q_t, _ = color_eval.class_channel_quantiles(
        jnp.asarray(tmpl), gamma, prior_weight=1e-6)
    q_s, _ = color_eval.class_channel_quantiles(
        jnp.asarray(src), gamma, prior_weight=1e-6)
    out = color_eval.image_dist_transform_quantile(
        jnp.asarray(src), gamma, q_s, q_t, space="rgb")
    assert out.dtype == jnp.uint8
    err_rgb = np.abs(np.asarray(out, np.float32) - tmpl).max()
    assert err_rgb <= 1.0, err_rgb

    tmpl_h = rgb_to_hsd(jnp.asarray(tmpl))
    src_h = rgb_to_hsd(jnp.asarray(src))
    qth, _ = color_eval.class_channel_quantiles(tmpl_h, gamma,
                                                prior_weight=1e-6)
    qsh, _ = color_eval.class_channel_quantiles(src_h, gamma,
                                                prior_weight=1e-6)
    outh = color_eval.image_dist_transform_quantile(src_h, gamma, qsh, qth)
    err_hsd = np.abs(np.asarray(outh, np.float32) - tmpl).max()
    assert err_hsd > 10.0, err_hsd  # the mechanism the RGB space closes

    with pytest.raises(ValueError):
        color_eval.image_dist_transform_quantile(
            jnp.asarray(src), gamma, q_s, q_t, space="lab")


def test_validate_rgb_quantile_transfer_runs():
    """validate(transfer='rgb-quantile') end to end: RGB-space template
    curves accumulated under the GMM responsibilities, deployed, NMI out."""
    flow, gmm, state, tx = init_flow_state(CFG, KEY)
    rng = np.random.default_rng(11)
    batches = [rng.random((2, 16, 16, 3), np.float32) for _ in range(2)]
    res = validate_flow.validate(
        flow, gmm, CFG, state.params, state.spectral,
        batches, batches, KEY, transfer="rgb-quantile")
    assert np.isfinite(res["nmi_sd"])
    assert res["outputs"][0].dtype == np.uint8


def test_validate_composite_transfers_run():
    """validate(transfer='full-quantile'/'rgb-full-quantile') end to end:
    RGB/HSD moments + quantile curves accumulated in the SAME space
    (moment_space contract of deploy(composite=True)), deployed, NMI out."""
    flow, gmm, state, tx = init_flow_state(CFG, KEY)
    rng = np.random.default_rng(12)
    batches = [rng.random((2, 16, 16, 3), np.float32) for _ in range(2)]
    for transfer in ("full-quantile", "rgb-full-quantile"):
        res = validate_flow.validate(
            flow, gmm, CFG, state.params, state.spectral,
            batches, batches, KEY, transfer=transfer)
        assert np.isfinite(res["nmi_sd"]), transfer
        assert res["outputs"][0].dtype == np.uint8, transfer


def test_rgb_full_quantile_identity_in_rgb_space():
    """space='rgb' composite: identity when source == template statistics
    (round trip within 1 u8 of the direct uint8 rendering, no HSD->RGB
    conversion applied on output)."""
    rng = np.random.default_rng(6)
    K = 2
    cls = rng.choice(K, size=(2, 32, 32))
    g = np.eye(K, dtype=np.float32)[cls]
    x = np.where(cls[..., None] == 0,
                 rng.normal(90.0, 12.0, (2, 32, 32, 3)),
                 rng.normal(180.0, 20.0, (2, 32, 32, 3))
                 ).astype(np.float32)
    x = np.clip(x, 0.0, 255.0)
    mu, cov = color_eval.class_color_cov(x, g)
    q, _ = color_eval.class_channel_quantiles(x, g)
    out = color_eval.image_dist_transform_full_quantile(
        x, g, mu, cov, mu, cov, q, space="rgb")
    assert out.shape == (2, 32, 32, 3) and out.dtype == jnp.uint8
    direct = np.clip(np.round(x), 0, 255).astype(np.uint8)
    assert np.abs(np.asarray(out, int) - direct.astype(int)).max() <= 1
    with pytest.raises(ValueError):
        color_eval.image_dist_transform_full_quantile(
            x, g, mu, cov, mu, cov, q, space="lab")


def test_full_quantile_transfer_identity_and_shapes():
    """The composite Monge+quantile transfer: identity when source ==
    template stats (round trip within 1 u8), valid uint8 output."""
    rng = np.random.default_rng(5)
    K = 2
    cls = rng.choice(K, size=(2, 32, 32))
    g = np.eye(K, dtype=np.float32)[cls]
    x = np.where(cls[..., None] == 0,
                 rng.normal(0.3, 0.05, (2, 32, 32, 3)),
                 rng.normal(0.7, 0.10, (2, 32, 32, 3))).astype(np.float32)
    mu, cov = color_eval.class_color_cov(x, g)
    q, _ = color_eval.class_channel_quantiles(x, g)
    out = color_eval.image_dist_transform_full_quantile(
        x, g, mu, cov, mu, cov, q)
    assert out.shape == (2, 32, 32, 3) and out.dtype == jnp.uint8
    from stainlib_tpu.ops.colorspace import hsd_to_rgb, to_uint8

    direct = to_uint8(hsd_to_rgb(x))
    assert np.abs(np.asarray(out, int) - np.asarray(direct, int)).max() <= 1


def test_quantile_transfer_empty_class_shrinks_to_global():
    """A class with ~zero responsibility mass gets the GLOBAL quantile
    curve (prior shrinkage) instead of unsupported noise — the measured
    template-empty-class failure of the reference's (mu, sigma) transfer
    (shifted centers route ~9% of pixels through a class the template
    never uses, scripts/seg_transfer_demo.py)."""
    rng = np.random.default_rng(4)
    K = 3
    gamma = np.zeros((1, 16, 16, K), np.float32)
    gamma[..., 0] = 0.7
    gamma[..., 1] = 0.3  # class 2 gets exactly zero mass
    hsd = rng.random((1, 16, 16, 3), np.float32)
    q, mass = color_eval.class_channel_quantiles(hsd, gamma)
    assert float(np.asarray(mass)[2]) == 0.0
    ones = np.ones((1, 16, 16, 1), np.float32)
    q_glob, _ = color_eval.class_channel_quantiles(hsd, ones,
                                                   prior_weight=0.0)
    assert np.allclose(np.asarray(q)[2], np.asarray(q_glob)[0], atol=1e-5)


def test_template_stats_return_cov():
    """accumulate_template_stats(return_cov=True) produces the (K,3,3)
    covariances whose diagonal matches the returned sigma^2."""
    flow, gmm, state, tx = init_flow_state(CFG, KEY)
    tmpl = _hsd_batch(4, seed=7)
    out = validate_flow.accumulate_template_stats(
        flow, gmm, CFG, state.params, state.spectral, [tmpl], KEY,
        return_cov=True)
    mu, sd, usage, cov = out.mu, out.sigma, out.usage, out.cov
    assert np.asarray(cov).shape == (CFG.n_clusters, 3, 3)
    var = np.einsum("kcc->kc", np.asarray(cov))
    assert np.allclose(var, np.asarray(sd) ** 2, atol=1e-4)
    assert np.isclose(float(np.sum(np.asarray(usage))), 1.0, atol=1e-5)

    # Quantile accumulation: (K, 3, P) monotone curves.
    out_q = validate_flow.accumulate_template_stats(
        flow, gmm, CFG, state.params, state.spectral, [tmpl], KEY,
        return_quantiles=True)
    q = np.asarray(out_q.quantiles)
    assert q.shape == (CFG.n_clusters, 3, 33)
    assert (np.diff(q, axis=-1) >= -1e-6).all()


@pytest.mark.slow
def test_multiscale_flow_trains_and_encodes():
    """Regression: n_scales=2 squeezes the latent grid below the image grid;
    the GMM must pool its conditioning and encode() must upsample gamma."""
    cfg = FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1, hidden=8,
                     n_power_series=2, n_clusters=3, lr=1e-3, warmup_iters=2)
    batch = _hsd_batch(4, seed=9)
    flow, gmm, state, tx = init_flow_state(cfg, KEY, sample_hsd=batch)
    step = make_train_step(flow, gmm, cfg, tx)
    state, loss = step(state, batch)
    assert np.isfinite(float(loss))
    bpd, z, gamma = encode(flow, gmm, state.params, state.spectral, cfg,
                           batch, KEY)
    assert z.shape == (4, 8, 8, 4)  # squeezed latent
    assert gamma.shape == (4, 16, 16, 3)  # upsampled back to the image grid
    mu, sd = color_eval.class_color_stats(batch, gamma)
    assert mu.shape == (3, 3)


@pytest.mark.slow
def test_remat_matches_plain():
    cfg_r = FlowConfig(image_size=16, n_scales=1, blocks_per_scale=1,
                       hidden=8, n_power_series=2, n_clusters=3, lr=1e-3,
                       warmup_iters=2, remat=True)
    batch = _hsd_batch(4, seed=11)
    flow, gmm, state, tx = init_flow_state(cfg_r, KEY, sample_hsd=batch)
    step_r = make_train_step(flow, gmm, cfg_r, tx)
    s_r, loss_r = step_r(state, batch)

    import dataclasses

    cfg_p = dataclasses.replace(cfg_r, remat=False)
    step_p = make_train_step(flow, gmm, cfg_p, tx)
    s_p, loss_p = step_p(state, batch)
    # Rematerialization changes memory, not math.
    np.testing.assert_allclose(float(loss_r), float(loss_p), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jax.tree.leaves(s_r.params)[0]),
        np.asarray(jax.tree.leaves(s_p.params)[0]), atol=1e-6,
    )


def test_nmi_metrics():
    rng = np.random.default_rng(0)
    img = rng.integers(100, 200, (32, 32, 3)).astype(np.uint8)
    mask = np.ones((32, 32), bool)
    val = float(color_eval.nmi(jnp.asarray(img), jnp.asarray(mask)))
    assert 0.5 < val <= 1.0
    sd, cv = color_eval.nmi_sd_cv([0.8, 0.9, 1.0])
    np.testing.assert_allclose(sd, np.std([0.8, 0.9, 1.0]), rtol=1e-6)
    np.testing.assert_allclose(cv, sd / 0.9, rtol=1e-6)


@pytest.mark.slow
def test_kernel_sizes_and_remat_logdet_step():
    # The reference-capacity knobs (3-1-3 bottleneck kernels + per-term
    # logdet remat) at toy scale: one step runs, loss finite, and the
    # remat'd logdet equals the unremat'd one for identical params/keys.
    cfg = FlowConfig(image_size=16, n_scales=2, blocks_per_scale=2, hidden=8,
                     n_power_series=3, kernel_sizes=(3, 1, 3),
                     remat_logdet=True, warmup_iters=2)
    hsd = np.asarray(
        rgb_to_hsd(jnp.asarray(he_batch(4, 16, 16, seed=5, background_frac=0.0))), np.float32)
    flow, gmm, state, tx = init_flow_state(
        cfg, jax.random.PRNGKey(0), sample_hsd=hsd)
    step = make_train_step(flow, gmm, cfg, tx)
    state2, loss = step(state, jnp.asarray(hsd))
    assert np.isfinite(float(loss))

    cfg_plain = dataclasses.replace(cfg, remat_logdet=False)
    flow2, gmm2, state_b, _ = init_flow_state(
        cfg_plain, jax.random.PRNGKey(0), sample_hsd=hsd)
    key = jax.random.PRNGKey(3)
    za, lda = flow.apply(
        {"params": state.params["flow"], "spectral": state.spectral},
        jnp.clip(hsd[..., 2:3] / 4.0, 1e-4, 1 - 1e-4), key)
    zb, ldb = flow2.apply(
        {"params": state_b.params["flow"], "spectral": state_b.spectral},
        jnp.clip(hsd[..., 2:3] / 4.0, 1e-4, 1 - 1e-4), key)
    np.testing.assert_allclose(np.asarray(za), np.asarray(zb), atol=1e-5)
    np.testing.assert_allclose(np.asarray(lda), np.asarray(ldb), atol=1e-4)


def test_reference_capacity_param_count():
    from stainlib_tpu.models.train_flow import reference_capacity

    cfg = reference_capacity()
    flow, gmm = build_models(cfg)
    x0 = jnp.full((1, cfg.image_size, cfg.image_size, 1), 0.5)
    k = jax.random.PRNGKey(0)
    fvars = jax.eval_shape(lambda: flow.init(k, x0, k))
    z_shape = jax.eval_shape(lambda v: flow.apply(v, x0, k)[0], fvars)
    gvars = jax.eval_shape(lambda: gmm.init(
        k, jnp.zeros(z_shape.shape),
        jnp.zeros((1, cfg.image_size, cfg.image_size, 2))))
    n = sum(int(np.prod(p.shape)) for p in jax.tree.leaves(fvars["params"]))
    n += sum(int(np.prod(p.shape)) for p in jax.tree.leaves(gvars["params"]))
    # Within 1% of the published 500,388 (README segmentation table).
    assert abs(n - 500_388) / 500_388 < 0.01, n


def test_nmi_per_class_reference_semantics():
    """nmi_per_class: argmax-membership masks, median/p95 per class per
    image, NaN for absent classes; class_nmi_sd_cv averages Bessel-
    corrected per-class SD/CV (train_img_horo.py:817-898)."""
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (2, 8, 8, 3)).astype(np.uint8)
    gamma = np.zeros((2, 8, 8, 3), np.float32)
    gamma[:, :4, :, 0] = 1.0   # class 0: top half
    gamma[:, 4:, :, 1] = 1.0   # class 1: bottom half; class 2 absent
    out = color_eval.nmi_per_class(rgb, gamma)
    assert out.shape == (2, 3)
    assert np.isnan(out[:, 2]).all()
    m = rgb[0, :4].astype(np.float64).mean(-1).ravel()
    want = np.median(m) / np.percentile(m, 95)
    np.testing.assert_allclose(out[0, 0], want, rtol=1e-12)

    sd, cv, per_class = color_eval.class_nmi_sd_cv(out)
    assert len(per_class) == 2  # absent class skipped
    v0 = out[:, 0]
    np.testing.assert_allclose(per_class[0][1], v0.std(ddof=1), rtol=1e-12)
    np.testing.assert_allclose(
        sd, np.mean([p[1] for p in per_class]), rtol=1e-12)
    assert cv > 0


def test_encode_other_spatial_size():
    # The flow is fully convolutional: params trained/init'd at
    # cfg.image_size must encode tiles of a different (squeeze-divisible)
    # size, with bpd and gamma following the INPUT's size — the capacity
    # deployment path of scripts/seg_transfer_demo.py --capacity-ckpt.
    import jax
    import jax.numpy as jnp

    from stainlib_tpu.models.train_flow import (
        FlowConfig, encode, init_flow_state)

    cfg = FlowConfig(image_size=16, n_scales=2, blocks_per_scale=1, hidden=8)
    key = jax.random.PRNGKey(0)
    flow, gmm, state, _ = init_flow_state(cfg, key)
    hsd = jnp.stack([
        jnp.full((8, 8, 3), 0.3, jnp.float32),
        jnp.full((8, 8, 3), 0.9, jnp.float32),
    ])  # 8 != cfg.image_size, divisible by the squeeze factor 2
    bpd, z, gamma = encode(flow, gmm, state.params, state.spectral, cfg,
                           hsd, key)
    assert bpd.shape == (2,) and np.isfinite(np.asarray(bpd)).all()
    assert gamma.shape[:3] == (2, 8, 8)
    np.testing.assert_allclose(np.asarray(gamma).sum(-1), 1.0, atol=1e-5)
