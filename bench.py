"""Benchmark: batched Macenko stain normalization, 256x256 tiles/sec/chip.

Primary metric: end-to-end ``ExtractiveStainNormalizer
('macenko').transform`` equivalents per second on one device — per-tile stain
matrix estimation + exact non-negative lasso + 99th-pct rescale +
reconstruction — vs. the CPU reference pipeline (numpy eigh + closed-form
lasso; note the true reference uses SPAMS' iterative LARS, which is *slower*
than this baseline, so vs_baseline is conservative).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"platform", "device_kind"}. Every config runs the functional jnp path.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

TILE = 256
BATCH = int(sys.argv[sys.argv.index("--batch") + 1]) if "--batch" in sys.argv else 256
ITERS = int(sys.argv[sys.argv.index("--iters") + 1]) if "--iters" in sys.argv else 10
# Configs: 'macenko' (default headline), 'vahadane', 'reinhard', 'augment'
# (HED jitter) or 'streaming' (sampler -> prefetch -> normalize); plus the
# model families: 'flow' (residual-flow+GMM train step) and 'dann'
# (adversarial train step); plus: 'large' (the drop-in API on one large
# field; --size for the side), 'pop' (fit-once/pop-many StainAugmentor
# draws), and 'slide' (whole-slide fixed-matrix apply).
CONFIG = (sys.argv[sys.argv.index("--config") + 1]
          if "--config" in sys.argv else "macenko")
# --size: field side for --config large (default 1024; try 2048).
SIZE = int(sys.argv[sys.argv.index("--size") + 1]) if "--size" in sys.argv else 0


# Synthetic H&E tiles and the CPU reference pipeline (numpy; reference
# formulas, see SURVEY.md section 3.1) live in stainlib_tpu/reference.py.
from stainlib_tpu.reference import cpu_transform, make_tiles  # noqa: E402


def _device():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind}


def bench_cpu(tiles, M_tgt, maxc_tgt, n=6, method="macenko"):
    cpu_transform(tiles[0], M_tgt, maxc_tgt, method)  # warm caches
    t0 = time.perf_counter()
    for i in range(n):
        cpu_transform(tiles[i % len(tiles)], M_tgt, maxc_tgt, method)
    return n / (time.perf_counter() - t0)


# --------------------------------------------------------------------------
# Device pipeline
# --------------------------------------------------------------------------


def chain_tps(jax, run, first, extra_args, batch):
    """Marginal per-batch throughput of a DEPENDENT dispatch chain.

    Each step feeds the previous output back as the first argument (all
    benched paths are shape-preserving uint8 -> uint8), the final output is
    drained by FETCHING an on-device scalar reduction, and the 1-chain time
    is subtracted from the N-chain time, which cancels the fixed dispatch
    and probe cost.

    ``extra_args``: per-step tuples of additional ``run`` arguments
    (len >= 2; the chain length is len(extra_args)). If the marginal time
    of the requested chain is smaller than the timer's jitter floor, the
    chain is lengthened (cycling ``extra_args``) until the signal clears
    it — short smoke configs (``--iters 3 --batch 32``) otherwise measure
    pure jitter and the subtraction can even go negative.
    """
    import jax.numpy as jnp

    probe = jax.jit(lambda x: jnp.max(x))
    float(probe(run(first, *extra_args[0])))  # warm the probe program

    def t_chain(chain):
        t0 = time.perf_counter()
        out = first
        for a in chain:
            out = run(out, *a)
        float(probe(out))
        return time.perf_counter() - t0

    # min over two runs at both ends: host-side jitter otherwise swamps
    # short chains.
    chain = list(extra_args)
    t1 = min(t_chain(chain[:1]), t_chain(chain[:1]))
    while True:
        tn = min(t_chain(chain), t_chain(chain))
        # Signal floor: the marginal must exceed both 20 ms of absolute
        # jitter and half the 1-chain round-trip before the
        # subtraction is trustworthy; cap the lengthening at 16x.
        if tn - t1 >= max(0.020, 0.5 * t1) or len(chain) >= 16 * len(extra_args):
            break
        chain = chain + chain
    if len(chain) != len(extra_args):
        # Make silent lengthening visible: a smoke --iters that ran a 16x
        # longer chain should say so (stderr; the stdout JSON line stays
        # single-purpose for the driver).
        print(f"[chain_tps] chain lengthened {len(extra_args)} -> "
              f"{len(chain)} steps to clear the jitter floor",
              file=sys.stderr, flush=True)
    marginal = tn - t1
    if marginal < 0.020:
        # Still inside the jitter floor even at max length (the same 20 ms
        # threshold the loop uses): report the conservative whole-chain
        # bound (charges the fixed round-trip to the steps) instead of
        # dividing by an untrustworthy marginal.
        return batch * len(chain) / tn
    return batch * (len(chain) - 1) / marginal


def bench_streaming():
    """The streaming WSI pipeline end to end — native tile sampling off
    synthetic WSIRAW slides, a double-buffered device prefetcher, and the
    jitted Macenko transform — with the HOST in the loop (this measures the
    whole system, not the device)."""
    import tempfile

    import jax
    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from stainlib_tpu.data import native
    from stainlib_tpu.data.pipeline import DevicePrefetcher
    from stainlib_tpu.data.preprocessing import array_to_wsiraw
    from stainlib_tpu.data.wsi import SamplerConfig, WsiSampler
    from stainlib_tpu.normalization import extractive

    tmp = tempfile.mkdtemp(prefix="bench_wsi_")
    # Two synthetic slides, ~2k x 2k, tissue everywhere except a border.
    for i in range(2):
        lv0 = np.full((2048, 2048, 3), 255, np.uint8)
        lv0[128:-128, 128:-128] = make_tiles(1, 1792, 1792, seed=i)[0]
        array_to_wsiraw(f"{tmp}/slide_{i}.wsr", lv0, n_levels=3)

    params = jax.tree.map(
        jax.block_until_ready,
        extractive.fit(jnp.asarray(make_tiles(1, seed=99)[0]),
                       method="macenko"),
    )
    cfg = SamplerConfig(tile=TILE, batch_size=64, batch_tumor_ratio=0.0,
                        stddev_min=5.0)
    sampler = WsiSampler(f"{tmp}/*.wsr", (), cfg, worker=0, num_workers=1)

    n_batches = max(ITERS, 4)
    host = (t for t, _ in sampler.train_batches(num_batches=n_batches + 1))
    # Several prefetch workers overlap sampling + host->device DMA; the
    # consumer never blocks per step, so compute and transfer pipeline (the
    # reference's double-buffered DataLoader role, train_img_horo.py:292-302).
    feed = DevicePrefetcher(host, depth=4, workers=3)

    run = jax.jit(lambda x: extractive.transform(params, x))
    run(next(feed)).block_until_ready()  # compile outside the timed region
    t0 = time.perf_counter()
    count = 0
    acc = None
    for x in feed:
        y = run(x)
        # Cheap dependent fold: keeps every output on the critical path,
        # while the inputs still stream/overlap freely.
        acc = y if acc is None else jnp.maximum(acc, y)
        count += x.shape[0]
    float(jnp.max(acc))  # artifact-proof drain
    elapsed = time.perf_counter() - t0
    tps = count / elapsed

    cpu_tps = bench_cpu(make_tiles(4), np.asarray(params.stain_matrix_target),
                        np.asarray(params.max_c_target), n=4)
    print(json.dumps({
        "metric": f"streaming_wsi_norm_{TILE}x{TILE}_tiles_per_sec_per_chip",
        "value": round(tps, 2),
        "unit": "tiles/s",
        "vs_baseline": round(tps / cpu_tps, 2),
        **_device(),
    }))


def bench_reinhard():
    """Batched Reinhard LAB transfer."""
    import jax
    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from stainlib_tpu.normalization import reinhard

    tiles = make_tiles(BATCH)
    target = make_tiles(1, seed=99)[0]
    params = jax.tree.map(jax.block_until_ready,
                          reinhard.fit(jnp.asarray(target)))
    dev_tiles = jax.device_put(tiles)
    run = jax.jit(lambda x: reinhard.transform(params, x))
    run(dev_tiles).block_until_ready()
    tps = chain_tps(jax, run, dev_tiles, [()] * (ITERS + 1), BATCH)

    # CPU baseline: the same formulas in numpy (reference uses OpenCV LUTs).
    def np_lab(I):
        c = I.astype(np.float64) / 255.0
        lin = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
        M = np.array([[0.412453, 0.357580, 0.180423],
                      [0.212671, 0.715160, 0.072169],
                      [0.019334, 0.119193, 0.950227]])
        xyz = lin @ M.T / np.array([0.950456, 1.0, 1.088754])
        f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16 / 116)
        L = np.where(xyz[..., 1] > 0.008856,
                     116 * np.cbrt(xyz[..., 1]) - 16, 903.3 * xyz[..., 1])
        return np.stack([L, 500 * (f[..., 0] - f[..., 1]),
                         200 * (f[..., 1] - f[..., 2])], -1)

    t_lab = np_lab(target)
    t_mu, t_sd = t_lab.mean((0, 1)), t_lab.std((0, 1))

    def cpu_one(I):
        p = np.percentile(I, 90)
        I = np.clip(I * 255.0 / p, 0, 255)
        lab = np_lab(I.astype(np.uint8))
        mu, sd = lab.mean((0, 1)), lab.std((0, 1))
        return (lab - mu) * (t_sd / sd) + t_mu  # inverse LAB omitted: lower
        # bound on CPU cost -> vs_baseline is conservative.

    cpu_one(tiles[0])
    t0 = time.perf_counter()
    for i in range(6):
        cpu_one(tiles[i % len(tiles)])
    cpu_tps = 6 / (time.perf_counter() - t0)
    print(json.dumps({
        "metric": f"reinhard_norm_{TILE}x{TILE}_tiles_per_sec_per_chip",
        "value": round(tps, 2),
        "unit": "tiles/s",
        "vs_baseline": round(tps / cpu_tps, 2),
        **_device(),
    }))


def bench_augment():
    """PRNG-keyed HED jitter, the flagship augmenter
    family (``augmenter.py:86-372``: randomize + transform fused, per-image
    draws), chained-dispatch on device vs the reference's per-image
    skimage-semantics path in numpy."""
    import jax
    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from stainlib_tpu.augmentation.functional import hed_jitter

    tiles = make_tiles(BATCH)
    dev = jax.device_put(tiles)
    run = jax.jit(hed_jitter)
    key = jax.random.PRNGKey(0)
    run(dev, key).block_until_ready()
    tps = chain_tps(
        jax, run, dev,
        [(jax.random.fold_in(key, i),) for i in range(ITERS + 1)], BATCH,
    )

    # CPU baseline: skimage rgb2hed/hed2rgb semantics in numpy, per image
    # (the reference calls skimage per patch, augmenter.py:295,319).
    rgb_from_hed = np.array([[0.65, 0.70, 0.29],
                             [0.07, 0.99, 0.11],
                             [0.27, 0.57, 0.78]])
    rgb_from_hed /= np.linalg.norm(rgb_from_hed, axis=1, keepdims=True)
    hed_from_rgb = np.linalg.inv(rgb_from_hed)
    log_adjust = np.log(1e-6)

    def cpu_one(I, rng):
        f = np.maximum(I.astype(np.float64) / 255.0, 1e-6)
        hed = (np.log(f) / log_adjust) @ hed_from_rgb
        hed = hed * (1.0 + rng.uniform(-0.1, 0.1, 3)) + rng.uniform(-0.1, 0.1, 3)
        rgb = np.exp(-(hed * -log_adjust) @ rgb_from_hed)
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

    rng = np.random.default_rng(0)
    cpu_one(tiles[0], rng)
    t0 = time.perf_counter()
    for i in range(6):
        cpu_one(tiles[i % len(tiles)], rng)
    cpu_tps = 6 / (time.perf_counter() - t0)
    print(json.dumps({
        "metric": f"hed_augment_{TILE}x{TILE}_tiles_per_sec_per_chip",
        "value": round(tps, 2),
        "unit": "tiles/s",
        "vs_baseline": round(tps / cpu_tps, 2),
        **_device(),
    }))


def _chain_state_steps(step_fn, state0, n, probe_of):
    """Time n state-threaded steps (marginal over a 1-step chain)."""
    def t_chain(k, st):
        t0 = time.perf_counter()
        out = None
        for _ in range(k):
            st, out = step_fn(st)
        float(probe_of(out))
        return time.perf_counter() - t0, st

    t1, state0 = t_chain(1, state0)
    t1b, state0 = t_chain(1, state0)
    tn, _ = t_chain(n + 1, state0)
    return (tn - min(t1, t1b)) / n


def bench_flow():
    """Residual-flow + GMM training step (the reference's train_img_horo
    inner loop): imgs/sec at 32x32 HSD, state-threaded chain timing."""
    import jax
    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from stainlib_tpu.models.train_flow import (
        FlowConfig, init_flow_state, make_train_step,
    )
    from stainlib_tpu.ops.colorspace import rgb_to_hsd

    batch = BATCH if "--batch" in sys.argv else 64
    cfg = FlowConfig(image_size=32, n_scales=2, blocks_per_scale=2,
                     hidden=32, n_clusters=4, warmup_iters=10)
    hsd = np.asarray(rgb_to_hsd(jnp.asarray(make_tiles(batch, 32, 32, seed=3))))
    flow, gmm, state, tx = init_flow_state(cfg, jax.random.PRNGKey(0),
                                           sample_hsd=hsd)
    step = jax.jit(make_train_step(flow, gmm, cfg, tx))
    dev_hsd = jax.device_put(hsd)
    state, loss = step(state, dev_hsd)
    float(loss)
    per = _chain_state_steps(lambda st: step(st, dev_hsd), state, ITERS,
                             lambda loss: loss)

    # Baseline: the same jitted step on the host CPU backend.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cstate = jax.device_put(jax.tree.map(np.asarray, state), cpu)
        chsd = jax.device_put(hsd, cpu)
        cstate, loss = step(cstate, chsd)
        float(loss)
        t0 = time.perf_counter()
        for _ in range(2):
            cstate, loss = step(cstate, chsd)
        float(loss)
        cpu_per = (time.perf_counter() - t0) / 2
    print(json.dumps({
        "metric": "flow_train_step_32x32_imgs_per_sec_per_chip",
        "value": round(batch / per, 2),
        "unit": "imgs/s",
        "vs_baseline": round(cpu_per / per, 2),
        **_device(),
    }))


def bench_dann():
    """DANN adversarial train step (3-phase schedule's costliest phase):
    imgs/sec at 63x63, state-threaded chain timing."""
    import jax
    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()

    from stainlib_tpu.models import dann

    batch = BATCH if "--batch" in sys.argv else 64
    rng = np.random.default_rng(0)
    model, state, tx = dann.init_dann(jax.random.PRNGKey(0), n_domains=8)
    step = dann.make_train_step(model, tx)
    imgs = jax.device_put(np.asarray(rng.random((batch, 63, 63, 3)),
                                     np.float32))
    mit = jax.device_put(rng.integers(0, 2, batch))
    dom = jax.device_put(rng.integers(0, 8, batch))
    state, m = step(state, imgs, mit, dom, *dann.PHASE_ADVERSARIAL)
    float(m["loss"])
    per = _chain_state_steps(
        lambda st: step(st, imgs, mit, dom, *dann.PHASE_ADVERSARIAL),
        state, ITERS, lambda m: m["loss"])

    # Baseline: the same jitted step on the host CPU backend.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        cstate = jax.device_put(jax.tree.map(np.asarray, state), cpu)
        ci, cm, cd = (jax.device_put(np.asarray(x), cpu)
                      for x in (imgs, mit, dom))
        cstate, m = step(cstate, ci, cm, cd, *dann.PHASE_ADVERSARIAL)
        float(m["loss"])
        t0 = time.perf_counter()
        for _ in range(2):
            cstate, m = step(cstate, ci, cm, cd, *dann.PHASE_ADVERSARIAL)
        float(m["loss"])
        cpu_per = (time.perf_counter() - t0) / 2
    print(json.dumps({
        "metric": "dann_adversarial_step_63x63_imgs_per_sec_per_chip",
        "value": round(batch / per, 2),
        "unit": "imgs/s",
        "vs_baseline": round(cpu_per / per, 2),
        **_device(),
    }))


def bench_large():
    """The drop-in API's route for one large field (``--size`` side,
    default 1024): whole-field estimation (streaming count-bisection
    percentiles above 512^2) + per-pixel apply, one jitted
    ``extractive.transform``. Reported in 256-equivalent tiles/s."""
    import jax

    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from stainlib_tpu.normalization import extractive

    h = SIZE or 1024
    b = max(BATCH * (256 * 256) // (h * h), 1)
    tiles = jax.device_put(jnp.asarray(make_tiles(b, h, h, seed=0)))
    target = jnp.asarray(make_tiles(1, seed=99)[0])
    params = jax.tree.map(jax.block_until_ready,
                          extractive.fit(target, method="macenko"))

    def run(x):
        return extractive.transform_jit(params, x)

    equiv = b * (h * h) // (TILE * TILE)
    tps = chain_tps(jax, run, tiles, [()] * (ITERS + 1), equiv)
    cpu_tps = bench_cpu(np.asarray(make_tiles(2)),
                        np.asarray(params.stain_matrix_target, np.float64),
                        np.asarray(params.max_c_target, np.float64), n=2)
    print(json.dumps({
        "metric": f"macenko_norm_{h}x{h}_256equiv_tiles_per_sec",
        "value": round(tps, 2), "unit": "tiles/s",
        "vs_baseline": round(tps / cpu_tps, 2),
        **_device(),
    }))


def bench_pop():
    """Fit-once/pop-many StainAugmentor: the per-draw rate with a cached
    per-tile Vahadane fit (augmenter.py:416-448 contract)."""
    import time as _t

    import jax

    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from stainlib_tpu.augmentation import functional as F

    tiles = jax.device_put(make_tiles(BATCH))
    params = jax.block_until_ready(
        jax.jit(F.stain_augment_fit, static_argnames="method")(
            tiles, method="vahadane"))

    @jax.jit
    def pop(x, key):
        # The draw depends on the previous one, so the chain is dependent.
        return F.stain_augment_pop(params, jax.random.fold_in(key, x[0, 0, 0, 0]))

    key = jax.random.PRNGKey(0)
    tps = chain_tps(jax, pop, tiles,
                    [(jax.random.fold_in(key, i),) for i in range(ITERS + 1)],
                    BATCH)
    # CPU baseline: one functional pop on the same host.
    small = F.stain_augment_fit(jnp.asarray(make_tiles(4)), method="macenko")
    jax.block_until_ready(small)
    with jax.default_device(jax.devices("cpu")[0]):
        cpu_params = jax.device_put(small, jax.devices("cpu")[0])
        # Warm (trace + compile + transfer) before timing, same protocol
        # as bench_slide — else the baseline is charged the compile.
        jax.block_until_ready(
            F.stain_augment_pop(cpu_params, jax.random.PRNGKey(0)))
        t0 = _t.perf_counter()
        out = F.stain_augment_pop(cpu_params, jax.random.PRNGKey(1))
        jax.block_until_ready(out)
        cpu_tps = 4 / (_t.perf_counter() - t0)
    print(json.dumps({
        "metric": f"stain_augment_pop_{TILE}x{TILE}_tiles_per_sec[fit_once]",
        "value": round(tps, 2), "unit": "tiles/s",
        "vs_baseline": round(tps / cpu_tps, 2),
        **_device(),
    }))


def bench_slide():
    """Whole-slide normalization apply: the fixed-matrix transform
    (``extractive.transform_with_matrix``) used by ``normalization/slide.py``
    with estimation='slide' — one stain matrix per slide, per-tile lasso +
    rescale + reconstruction with no percentile chains."""
    import time as _t

    import jax

    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from stainlib_tpu.normalization import extractive

    tiles = make_tiles(BATCH)
    target = make_tiles(1, seed=99)[0]
    params = jax.device_get(jax.jit(extractive.fit)(jnp.asarray(target)))
    src = jax.device_get(jax.jit(extractive.fit)(jnp.asarray(tiles[0])))

    def step(x):
        return extractive.transform_with_matrix(
            x, src.stain_matrix_target, src.max_c_target, params)

    tps = chain_tps(jax, jax.jit(step), jax.device_put(tiles),
                    [()] * (ITERS + 1), BATCH)

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        small = jax.device_put(jnp.asarray(tiles[:4]), cpu)
        fn = jax.jit(step)
        jax.block_until_ready(fn(small))
        t0 = _t.perf_counter()
        jax.block_until_ready(fn(small))
        cpu_tps = 4 / (_t.perf_counter() - t0)
    print(json.dumps({
        "metric": f"slide_norm_apply_{TILE}x{TILE}_tiles_per_sec[fixed_matrix]",
        "value": round(tps, 2), "unit": "tiles/s",
        "vs_baseline": round(tps / cpu_tps, 2),
        **_device(),
    }))


def main():
    if CONFIG == "streaming":
        return bench_streaming()
    if CONFIG == "reinhard":
        return bench_reinhard()
    if CONFIG == "augment":
        return bench_augment()
    if CONFIG == "flow":
        return bench_flow()
    if CONFIG == "dann":
        return bench_dann()
    if CONFIG == "large":
        return bench_large()
    if CONFIG == "pop":
        return bench_pop()
    if CONFIG == "slide":
        return bench_slide()
    import jax

    from stainlib_tpu.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax.numpy as jnp

    from stainlib_tpu.normalization import extractive

    tiles = make_tiles(BATCH)
    target = make_tiles(1, seed=99)[0]

    params = jax.tree.map(
        jax.block_until_ready,
        extractive.fit(jnp.asarray(target), method=CONFIG),
    )
    M_tgt = np.asarray(params.stain_matrix_target, np.float64)
    maxc_tgt = np.asarray(params.max_c_target, np.float64)

    dev_tiles = jax.device_put(tiles)
    step = jax.jit(lambda x: extractive.transform(params, x, method=CONFIG))
    step(dev_tiles).block_until_ready()
    tps = chain_tps(jax, step, dev_tiles, [()] * (ITERS + 1), BATCH)

    cpu_tps = bench_cpu(tiles, M_tgt, maxc_tgt, method=CONFIG)

    print(json.dumps({
        "metric": f"{CONFIG}_norm_{TILE}x{TILE}_tiles_per_sec_per_chip",
        "value": round(tps, 2),
        "unit": "tiles/s",
        "vs_baseline": round(tps / cpu_tps, 2),
        **_device(),
    }))


if __name__ == "__main__":
    main()
