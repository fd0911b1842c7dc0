"""Sharding tests on the simulated 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stainlib_tpu.parallel.collectives import data_parallel_step
from stainlib_tpu.parallel.mesh import local_data_shard, make_mesh
from stainlib_tpu.parallel.stain_sharded import (
    normalize_batch_sharded,
    sharded_concentrations,
)
from tests.synth import HE_TRUE, he_batch, he_patch


requires_8 = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 simulated devices"
)


@requires_8
def test_make_mesh_axes():
    mesh = make_mesh(8, data=2, tiles=4)
    assert mesh.axis_names == ("data", "tiles")
    assert mesh.devices.shape == (2, 4)


@requires_8
@pytest.mark.slow
def test_sharded_normalize_matches_single_device():
    mesh = make_mesh(8, data=8)
    target = jnp.asarray(he_patch(32, 32, seed=80))
    batch = jnp.asarray(he_batch(8, 32, 32, seed=81))
    out = np.asarray(normalize_batch_sharded(mesh, target, batch))

    from stainlib_tpu.normalization import extractive

    params = extractive.fit(target, method="macenko")
    want = np.asarray(extractive.transform(params, batch, method="macenko"))
    # Sharded compilation may reorder float reductions: allow one uint8 step.
    diff = np.abs(out.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


@requires_8
def test_sharded_concentrations_match():
    mesh = make_mesh(8, pixel=8)
    rng = np.random.default_rng(0)
    od = np.abs(rng.standard_normal((8 * 64, 3))).astype(np.float32)
    M = jnp.asarray(HE_TRUE, jnp.float32)
    got = np.asarray(sharded_concentrations(mesh, jnp.asarray(od), M))

    from stainlib_tpu.ops.lasso import nonneg_lasso_k2

    want = np.asarray(nonneg_lasso_k2(jnp.asarray(od), M))
    np.testing.assert_allclose(got, want, atol=1e-6)


@requires_8
def test_data_parallel_step_grads_match_global():
    mesh = make_mesh(8, data=8)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 5)).astype(np.float32)
    y = rng.standard_normal((64,)).astype(np.float32)
    w = jnp.zeros((5,), jnp.float32)

    def loss_fn(w, batch):
        xb, yb = batch
        return jnp.mean((xb @ w - yb) ** 2)

    step = data_parallel_step(mesh, loss_fn)
    loss, grads = step(w, (jnp.asarray(x), jnp.asarray(y)))
    want = jax.grad(loss_fn)(w, (jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_allclose(np.asarray(grads), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        float(loss), float(loss_fn(w, (jnp.asarray(x), jnp.asarray(y)))), rtol=1e-6
    )


def test_local_data_shard_partition():
    starts_ends = [local_data_shard(100, pi, 8) for pi in range(8)]
    for i, (s, e) in enumerate(starts_ends):
        assert e - s == 12 and s == i * 12


@requires_8
@pytest.mark.slow
def test_graft_dryrun_multichip():
    import importlib.util, pathlib

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", pathlib.Path(__file__).parent.parent / "__graft_entry__.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.dryrun_multichip(8)


@requires_8
@pytest.mark.parametrize("method", ["macenko", "vahadane"])
def test_sharded_matches_single_device_bitwise(method):
    # Per-tile estimation is shard-local, so sharding the batch over the
    # 'data' axis must not change a single value against the same program
    # run on one device.
    mesh = make_mesh(8, data=8)
    target = jnp.asarray(he_patch(32, 128, seed=88))
    batch = jnp.asarray(he_batch(8, 32, 128, seed=89))
    got = np.asarray(
        normalize_batch_sharded(mesh, target, batch, method=method))

    from stainlib_tpu.normalization import extractive

    params = extractive.fit(target, method=method)
    want = np.asarray(jax.jit(extractive.transform, static_argnames="method")(
        params, batch, method=method))
    np.testing.assert_array_equal(got, want)


@pytest.mark.slow
def test_capacity_config_compiles_8way():
    """The PUBLISHED-capacity flow config (500k params, 256^2) AOT-compiles
    under an 8-way data-parallel mesh — the scale the reference ran across
    8 Horovod workers (train_img_horo.py:1116-1172). Compile-only (lower()
    .compile()): execution at this size belongs on real chips; what this
    pins is that the shardings, collectives and remat survive SPMD
    partitioning at full capacity, not just the dryrun's toy shapes."""
    from stainlib_tpu.models.train_flow import (
        init_flow_state, make_train_step, reference_capacity)

    cfg = reference_capacity()
    mesh = make_mesh()
    key = jax.random.PRNGKey(0)
    sample = np.random.default_rng(0).random(
        (8, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    flow, gmm, state, tx = init_flow_state(cfg, key, sample_hsd=sample)
    step = make_train_step(flow, gmm, cfg, tx, mesh=mesh)
    batch = jnp.asarray(np.tile(sample, (2, 1, 1, 1)))  # 2 per device
    compiled = step.lower(state, batch).compile()
    assert compiled is not None


def test_template_sums_psum_matches_single_device():
    """The extended template statistics (incl. the covariance `xxT` and
    quantile-barycenter `wq` accumulators) driven
    through the 8-device mesh — per-shard encode -> local sums ->
    `psum_stats` allreduce (the hvd.allreduce of train_img_horo.py:742-748)
    must reproduce the single-device accumulation at matching batch
    granularity (2 tiles per shard == 2-tile host batches; gamma is
    key-independent and batch-split exact, so only f32 reduction order
    differs)."""
    from stainlib_tpu.models.train_flow import FlowConfig, init_flow_state
    from stainlib_tpu.models.validate_flow import (
        accumulate_template_sums, finalize_stats, template_sums_sharded)

    cfg = FlowConfig(image_size=16, n_scales=1, blocks_per_scale=1, hidden=8,
                     n_power_series=2, n_clusters=3, lr=1e-3, warmup_iters=2)
    key = jax.random.PRNGKey(0)
    flow, gmm, state, _ = init_flow_state(cfg, key)
    hsd = np.random.default_rng(3).random((16, 16, 16, 3)).astype(np.float32)

    mesh = make_mesh(8, data=8)
    k = jax.random.PRNGKey(7)
    sharded = template_sums_sharded(
        flow, gmm, cfg, state.params, state.spectral, hsd, k, mesh,
        with_cov=True, with_quantiles=True)
    single = accumulate_template_sums(
        flow, gmm, cfg, state.params, state.spectral,
        [hsd[i:i + 2] for i in range(0, 16, 2)], k,
        with_cov=True, with_quantiles=True)

    for name, a, b in zip(sharded._fields, sharded, single):
        assert (a is None) == (b is None), name
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-4, err_msg=name)

    st_sh, st_si = finalize_stats(sharded), finalize_stats(single)
    for name, a, b in zip(st_sh._fields, st_sh, st_si):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-5, atol=1e-4, err_msg=name)
    assert np.asarray(st_sh.cov).shape == (3, 3, 3)
    assert np.asarray(st_sh.quantiles).shape[0] == 3


def test_validate_mesh_template_pass():
    """validate(mesh=...) runs the template pass sharded (psum'd sums) and
    produces the same metric keys as the single-device path; mu/sigma agree
    with the single-device template statistics."""
    from stainlib_tpu.models.train_flow import FlowConfig, init_flow_state
    from stainlib_tpu.models.validate_flow import validate

    cfg = FlowConfig(image_size=16, n_scales=1, blocks_per_scale=1, hidden=8,
                     n_power_series=2, n_clusters=3, lr=1e-3, warmup_iters=2)
    flow, gmm, state, _ = init_flow_state(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    tmpl = rng.random((8, 16, 16, 3)).astype(np.float32)
    test = rng.random((8, 16, 16, 3)).astype(np.float32) * 0.8 + 0.1
    mesh = make_mesh(8, data=8)
    kwargs = dict(log=lambda *_: None, transfer="full")
    res_mesh = validate(flow, gmm, cfg, state.params, state.spectral,
                        [tmpl], [test], jax.random.PRNGKey(1),
                        mesh=mesh, **kwargs)
    res_one = validate(flow, gmm, cfg, state.params, state.spectral,
                       [tmpl], [test], jax.random.PRNGKey(1), **kwargs)
    np.testing.assert_allclose(res_mesh["mu_tmpl"], res_one["mu_tmpl"],
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(res_mesh["sigma_tmpl"], res_one["sigma_tmpl"],
                               rtol=2e-5, atol=1e-4)
    assert np.isfinite(res_mesh["nmi_sd"])
