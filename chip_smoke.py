#!/usr/bin/env python
"""Smoke test of the stain pipeline on an NVIDIA GPU, at the sizes users pass.

    python chip_smoke.py                # one GPU, every phase below
    python chip_smoke.py --four-cards   # the data-parallel path on 4 GPUs

Each phase drives a user entry point on the GPU, times its first call
(compile included) and its steady call (median of the next calls, each
ended by ``block_until_ready``), and checks the output three ways:

* against the same jnp function run on the host CPU, same inputs and seed:
  at most one uint8 step at any pixel (the GPU sums in another order, which
  can move a value across a rounding boundary). Reinhard is allowed two
  steps (``REINHARD_MAX_STEP``): it passes through the reference's uint8
  LAB image, and when the reordered per-tile mean/std moves a packed L
  value across an integer, the floor moves L by 1/2.55, about one RGB
  step, which the final rounding can make two;
* against the plain numpy reference (``stainlib_tpu/reference.py``): mean
  CIE76 delta-E below 1;
* Vahadane's stain matrices against the CPU's, within ``VAHADANE_M_TOL``.

Every float32 contraction on these paths asks for ``Precision.HIGHEST``
(otherwise the GPU may run it in TF32). The script exits non-zero, and
prints no result, when JAX finds no GPU or when any phase fails. Its last
line is one JSON object: ``{"ok": true, "device": {...}}``.

Phase "slide" (``normalize_slide`` on a synthetic 8192^2 slide) is not
here: it writes its output through the native libtiff writer, and the GPU
host this script targets has no libtiff headers to build it against.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np

VAHADANE_M_TOL = 1e-3
DELTA_E_MAX = 1.0
MAX_STEP = 1
REINHARD_MAX_STEP = 2
PRECISION = "f32, contractions at Precision.HIGHEST"


def _require_gpu(count: int = 1):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < count:
        print(f"chip_smoke: needs {count} GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        sys.exit(2)
    return devs


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _timed(fn, *args, repeats: int = 5):
    """(output, first-call seconds, median steady seconds)."""
    t0 = time.perf_counter()
    out = _block(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _block(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, float(np.median(times))


def _on(device, tree):
    import jax

    return jax.device_put(tree, device)


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _xla_bytes(fn, *args) -> float:
    """Bytes XLA's cost model says one call of ``fn`` accesses."""
    import jax

    cost = jax.jit(fn).lower(*args).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float((cost or {}).get("bytes accessed", float("nan")))


def _step_diff(a, b):
    d = np.abs(np.asarray(a).astype(np.int32) - np.asarray(b).astype(np.int32))
    return int(d.max()), float((d > 0).mean())


class Phase:
    """One phase's numbers and gates; ``line()`` is what it prints."""

    def __init__(self, name: str, shapes: str):
        self.name, self.shapes = name, shapes
        self.fields: dict = {}
        self.failures: list = []

    def gate(self, label: str, value, limit, ok: bool):
        self.fields[label] = value
        if not ok:
            self.failures.append(f"{label}={value} (limit {limit})")

    def check_pixels(self, got, cpu, ref_de, label="", max_step=MAX_STEP):
        step, frac = _step_diff(got, cpu)
        self.gate(f"max_step{label}", step, max_step, step <= max_step)
        self.fields[f"frac_diff{label}"] = frac
        if max_step > 1:
            d = np.abs(np.asarray(got).astype(np.int32)
                       - np.asarray(cpu).astype(np.int32))
            self.fields[f"frac_over1{label}"] = float((d > 1).mean())
        self.gate(f"dE{label}", round(ref_de, 6), DELTA_E_MAX,
                  ref_de < DELTA_E_MAX)

    @property
    def ok(self) -> bool:
        return not self.failures

    def line(self) -> str:
        f = " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in self.fields.items())
        status = "ok" if self.ok else "FAIL " + "; ".join(self.failures)
        return f"phase {self.name} [{self.shapes}; {PRECISION}] {f} {status}"


# --------------------------------------------------------------------------
# Phases on one device
# --------------------------------------------------------------------------


def phase_extractive(method: str = "macenko", n: int = 256, size: int = 256,
                     n_ref: int = 16) -> Phase:
    """``extractive.fit`` on a target, then ``extractive.transform`` jitted
    on ``n`` tiles of ``size``^2."""
    import jax
    import jax.numpy as jnp

    from stainlib_tpu import reference as R
    from stainlib_tpu.extraction.vahadane import stain_matrix_vahadane
    from stainlib_tpu.normalization import extractive

    ph = Phase(method, f"target {size}^2, {n} tiles of {size}^2")
    target = R.make_tiles(1, size, size, seed=99)[0]
    tiles = R.make_tiles(n, size, size, seed=1)
    fit = jax.jit(functools.partial(extractive.fit, method=method))
    tr = jax.jit(functools.partial(extractive.transform, method=method))

    params = fit(jnp.asarray(target))
    x = jax.device_put(tiles)
    got, first, steady = _timed(tr, params, x)
    ph.fields.update(compile_s=first, steady_s=steady,
                     tiles_per_s=n / steady,
                     min_bytes=2 * tiles.nbytes,
                     xla_bytes=_xla_bytes(tr, params, x))

    cpu = _cpu()
    cparams = fit(_on(cpu, target))
    want = tr(cparams, _on(cpu, tiles))
    M, mc = R.extractive_fit(target, method)
    ref = np.stack([R.cpu_transform(t, M, mc, method) for t in tiles[:n_ref]])
    ph.check_pixels(got, want, R.delta_e(np.asarray(got)[:n_ref], ref))
    ph.fields["dE_tiles"] = min(n, n_ref)
    if method == "vahadane":
        sm = jax.jit(stain_matrix_vahadane)
        dm = float(np.abs(np.asarray(sm(x)) - np.asarray(sm(_on(cpu, tiles))))
                   .max())
        ph.gate("M_maxdiff", dm, VAHADANE_M_TOL, dm <= VAHADANE_M_TOL)
    return ph


def phase_reinhard(n: int = 256, size: int = 256, n_ref: int = 16) -> Phase:
    """``reinhard.fit`` on a target, then ``reinhard.transform`` jitted on
    ``n`` tiles of ``size``^2."""
    import jax
    import jax.numpy as jnp

    from stainlib_tpu import reference as R
    from stainlib_tpu.normalization import reinhard

    ph = Phase("reinhard", f"target {size}^2, {n} tiles of {size}^2")
    target = R.make_tiles(1, size, size, seed=99)[0]
    tiles = R.make_tiles(n, size, size, seed=2)
    fit = jax.jit(reinhard.fit)
    tr = jax.jit(reinhard.transform)
    params = fit(jnp.asarray(target))
    x = jax.device_put(tiles)
    got, first, steady = _timed(tr, params, x)
    ph.fields.update(compile_s=first, steady_s=steady,
                     tiles_per_s=n / steady, min_bytes=2 * tiles.nbytes,
                     xla_bytes=_xla_bytes(tr, params, x))
    cpu = _cpu()
    want = tr(fit(_on(cpu, target)), _on(cpu, tiles))
    tm, ts = R.reinhard_fit(target)
    ref = np.stack([R.reinhard_transform(t, tm, ts) for t in tiles[:n_ref]])
    ph.check_pixels(got, want, R.delta_e(np.asarray(got)[:n_ref], ref),
                    max_step=REINHARD_MAX_STEP)
    ph.fields["dE_tiles"] = min(n, n_ref)
    return ph


def phase_fixed_matrix(n: int = 256, size: int = 256, n_ref: int = 16) -> Phase:
    """The slide-level apply (``extractive.transform_with_matrix``: one
    source stain matrix for every tile) jitted on ``n`` tiles."""
    import jax

    from stainlib_tpu import reference as R
    from stainlib_tpu.normalization import extractive

    ph = Phase("fixed_matrix", f"{n} tiles of {size}^2, one source matrix")
    target = R.make_tiles(1, size, size, seed=99)[0]
    source = R.make_tiles(1, size, size, seed=98)[0]
    tiles = R.make_tiles(n, size, size, seed=3)
    fit = jax.jit(extractive.fit)
    tr = jax.jit(extractive.transform_with_matrix)

    def inputs(device):
        p = fit(_on(device, target))
        s = fit(_on(device, source))
        return _on(device, tiles), s.stain_matrix_target, s.max_c_target, p

    args = inputs(jax.devices()[0])
    got, first, steady = _timed(tr, *args)
    ph.fields.update(compile_s=first, steady_s=steady,
                     tiles_per_s=n / steady, min_bytes=2 * tiles.nbytes,
                     xla_bytes=_xla_bytes(tr, *args))
    want = tr(*inputs(_cpu()))
    M, mc = R.extractive_fit(target)
    Ms, mcs = R.extractive_fit(source)
    ref = []
    for t in tiles[:n_ref]:
        C = R.lasso(R.od(t).reshape(-1, 3), Ms) * (mc / mcs)
        ref.append(np.clip(255.0 * np.exp(-(C @ M)), 0, 255)
                   .astype(np.uint8).reshape(t.shape))
    ph.check_pixels(got, want, R.delta_e(np.asarray(got)[:n_ref],
                                         np.stack(ref)))
    ph.fields["dE_tiles"] = min(n, n_ref)
    return ph


def phase_dropin(sizes=(63, 224, 2048), target_size: int = 256) -> Phase:
    """The drop-in objects on single images: ``ExtractiveStainNormalizer``
    (macenko, vahadane) and ``ReinhardStainNormalizer``. Above 512^2 the
    percentiles take the streaming count-bisection route."""
    import jax

    from stainlib_tpu import api
    from stainlib_tpu import reference as R

    ph = Phase("dropin", "images " + ", ".join(f"{s}^2" for s in sizes)
               + f"; target {target_size}^2")
    target = R.make_tiles(1, target_size, target_size, seed=99)[0]
    ref_fit = {m: R.extractive_fit(target, m) for m in ("macenko", "vahadane")}
    ref_rein = R.reinhard_fit(target)

    def make(kind):
        if kind == "reinhard":
            obj = api.ReinhardStainNormalizer()
        else:
            obj = api.ExtractiveStainNormalizer(kind)
        obj.fit(target)
        return obj

    for size in sizes:
        img = R.make_tiles(1, size, size, seed=size)[0]
        for kind in ("macenko", "vahadane", "reinhard"):
            obj = make(kind)
            got, first, steady = _timed(obj.transform, img, repeats=3)
            with jax.default_device(_cpu()):
                want = make(kind).transform(img)
            if kind == "reinhard":
                ref = R.reinhard_transform(img, *ref_rein)
            else:
                ref = R.cpu_transform(img, *ref_fit[kind], method=kind)
            tag = f"_{kind}{size}"
            ph.fields[f"compile_s{tag}"] = first
            ph.fields[f"steady_s{tag}"] = steady
            ph.check_pixels(got, want, R.delta_e(got, ref), tag,
                            REINHARD_MAX_STEP if kind == "reinhard"
                            else MAX_STEP)
    return ph


def phase_augment(n: int = 256, size: int = 256, pops: int = 4) -> Phase:
    """``HedLightColorAugmenter`` randomize+transform on ``n`` tiles, and
    ``StainAugmentor('macenko')`` fit followed by ``pops`` pops on one
    tile; the CPU objects get the same seeds, so the same draws."""
    import jax
    import jax.numpy as jnp

    from stainlib_tpu import reference as R
    from stainlib_tpu.augmentation import HedLightColorAugmenter, StainAugmentor

    ph = Phase("augment", f"HED on {n} tiles of {size}^2 x{pops}; "
                          f"StainAugmentor fit + {pops} pops on {size}^2")
    tiles = R.make_tiles(n, size, size, seed=4)

    hed, hed_cpu = HedLightColorAugmenter(seed=0), HedLightColorAugmenter(seed=0)
    times, worst, frac, de = [], 0, 0.0, 0.0
    for _ in range(pops):
        hed.randomize()
        with jax.default_device(_cpu()):
            hed_cpu.randomize()
            want = hed_cpu.transform(tiles)
        t0 = time.perf_counter()
        got = hed.transform(tiles)
        times.append(time.perf_counter() - t0)
        s, f = _step_diff(got, want)
        worst, frac = max(worst, s), max(frac, f)
        ref = np.stack([R.hed_apply(t, hed._sigmas, hed._biases, (0.05, 0.95))
                        for t in tiles[:16]])
        de = max(de, R.delta_e(got[:16], ref))
    ph.fields.update(hed_first_s=times[0],
                     hed_steady_s=float(np.median(times[1:] or times)))
    ph.gate("max_step_hed", worst, MAX_STEP, worst <= MAX_STEP)
    ph.fields["frac_diff_hed"] = frac
    ph.gate("dE_hed", round(de, 6), DELTA_E_MAX, de < DELTA_E_MAX)

    img = tiles[0]
    aug, aug_cpu = StainAugmentor("macenko", seed=0), StainAugmentor("macenko", seed=0)
    t0 = time.perf_counter()
    aug.fit(img)
    ph.fields["stain_fit_s"] = time.perf_counter() - t0
    with jax.default_device(_cpu()):
        aug_cpu.fit(img)
    key = jax.random.PRNGKey(0)
    worst, frac, de, t_pop = 0, 0.0, 0.0, []
    for _ in range(pops):
        t0 = time.perf_counter()
        got = aug.pop()
        t_pop.append(time.perf_counter() - t0)
        with jax.default_device(_cpu()):
            want = aug_cpu.pop()
            key, k = jax.random.split(key)
            k_a, k_b = jax.random.split(k)
            alpha = np.asarray(jax.random.uniform(k_a, (2,), jnp.float32,
                                                  0.8, 1.2))
            beta = np.asarray(jax.random.uniform(k_b, (2,), jnp.float32,
                                                 -0.2, 0.2))
        s, f = _step_diff(got, want)
        worst, frac = max(worst, s), max(frac, f)
        de = max(de, R.delta_e(got, R.stain_augment(img, alpha, beta)))
    ph.fields.update(pop_first_s=t_pop[0],
                     pop_steady_s=float(np.median(t_pop[1:] or t_pop)))
    ph.gate("max_step_pop", worst, MAX_STEP, worst <= MAX_STEP)
    ph.fields["frac_diff_pop"] = frac
    ph.gate("dE_pop", round(de, 6), DELTA_E_MAX, de < DELTA_E_MAX)
    return ph


def phase_pop_batch(n: int = 256, size: int = 256) -> Phase:
    """Fit-once/pop-many on a batch: ``stain_augment_fit`` once on ``n``
    tiles, then jitted ``stain_augment_pop`` draws."""
    import jax

    from stainlib_tpu import reference as R
    from stainlib_tpu.augmentation import functional as F

    ph = Phase("pop_batch", f"fit once on {n} tiles of {size}^2, pop")
    tiles = R.make_tiles(n, size, size, seed=5)
    fit = jax.jit(F.stain_augment_fit, static_argnames="method")
    pop = jax.jit(F.stain_augment_pop)
    key = jax.random.PRNGKey(7)
    params = fit(jax.device_put(tiles), method="macenko")
    got, first, steady = _timed(pop, params, key)
    ph.fields.update(compile_s=first, steady_s=steady,
                     tiles_per_s=n / steady,
                     min_bytes=tiles.nbytes + tiles.nbytes,
                     xla_bytes=_xla_bytes(pop, params, key))
    cpu = _cpu()
    want = pop(fit(_on(cpu, tiles), method="macenko"), _on(cpu, key))
    step, frac = _step_diff(got, want)
    ph.gate("max_step", step, MAX_STEP, step <= MAX_STEP)
    ph.fields["frac_diff"] = frac
    return ph


PHASES = (
    functools.partial(phase_extractive, "macenko", n=256),
    functools.partial(phase_extractive, "vahadane", n=128),
    phase_reinhard,
    phase_fixed_matrix,
    phase_dropin,
    phase_augment,
    phase_pop_batch,
)


# --------------------------------------------------------------------------
# Four cards
# --------------------------------------------------------------------------


def phase_four_cards(n_dev: int = 4, n: int = 256, size: int = 256,
                     n_pixels: int = 1 << 22) -> Phase:
    """``normalize_batch_sharded`` over an ``n_dev``-device 'data' mesh and
    ``sharded_concentrations`` over a 'pixel' mesh, each compared bit for
    bit with the same computation on one device."""
    import jax
    import jax.numpy as jnp

    from stainlib_tpu import reference as R
    from stainlib_tpu.normalization import extractive
    from stainlib_tpu.ops.lasso import nonneg_lasso_k2
    from stainlib_tpu.parallel.mesh import make_mesh
    from stainlib_tpu.parallel.stain_sharded import (
        normalize_batch_sharded, sharded_concentrations)

    ph = Phase("four_cards", f"{n_dev} devices; {n} tiles of {size}^2 over "
                             f"'data'; {n_pixels} OD pixels over 'pixel'")
    target = R.make_tiles(1, size, size, seed=99)[0]
    tiles = R.make_tiles(n, size, size, seed=6)
    mesh = make_mesh(n_dev, data=n_dev)
    run = functools.partial(normalize_batch_sharded, mesh, jnp.asarray(target))
    got, first, steady = _timed(run, tiles)
    ph.fields.update(compile_s=first, steady_s=steady, tiles_per_s=n / steady)

    # One device running the same program: the same (eager) fit, then the
    # jitted transform on each device's share of the batch, which must
    # match bit for bit. On the whole batch at once XLA may pick another
    # reduction strategy for the larger shape, so there the gate is the
    # usual one uint8 step.
    dev0 = jax.devices()[0]
    params = extractive.fit(_on(dev0, target))
    tr = jax.jit(extractive.transform)
    shards = np.concatenate([np.asarray(tr(params, _on(dev0, part)))
                             for part in np.split(tiles, n_dev)])
    same = bool(np.array_equal(np.asarray(got), shards))
    ph.gate("data_bitwise_vs_1card_same_shards", same, True, same)
    step, frac = _step_diff(got, tr(params, _on(dev0, tiles)))
    ph.gate("data_max_step_vs_1card_whole", step, MAX_STEP, step <= MAX_STEP)
    ph.fields["data_frac_diff_vs_1card_whole"] = frac

    rng = np.random.default_rng(0)
    od = np.abs(rng.standard_normal((n_pixels, 3))).astype(np.float32)
    M = R.macenko(target).astype(np.float32)
    pmesh = make_mesh(n_dev, pixel=n_dev)
    c_got = sharded_concentrations(pmesh, od, M)
    c_want = jax.jit(nonneg_lasso_k2)(_on(dev0, od), _on(dev0, M))
    same = bool(np.array_equal(np.asarray(c_got), np.asarray(c_want)))
    ph.gate("pixel_bitwise", same, True, same)
    return ph


# --------------------------------------------------------------------------


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    devs = _require_gpu(4 if four else 1)

    print(f"card: {_card_line()}", flush=True)
    print(f"jax: {devs[0].platform} {devs[0].device_kind} x{len(devs)}",
          flush=True)
    phases = (phase_four_cards,) if four else PHASES
    failed = []
    for fn in phases:
        ph = fn()
        print(ph.line(), flush=True)
        if not ph.ok:
            failed.append(ph.name)
    if failed:
        print(f"chip_smoke: FAILED phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
