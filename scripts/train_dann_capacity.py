"""Train the TCGA-capacity DANN (MobileNet alpha=0.5 trunk) on chip.

The reference's TCGA experiment (``tcga_dann_4reps.py:66-168``) trains a
keras ``MobileNet(input_shape=(224,224,3), alpha=0.5, include_top=False,
pooling='avg')`` trunk with two Dense(256)->Dense(128)->softmax heads
(task = Gleason GP3/GP4, domain behind gradient reversal), Adam lr=1e-3,
batch 64, alternating the three phase weight settings per iteration:
(w_task, w_dom, hp_lambda) = (1,0,0), (0,1,-1), (1,1,1).

This driver runs that exact configuration — trunk parity is asserted to
the parameter (params + BN stats == keras's published 829,536) — on the
synthetic two-domain task at 224x224, and reports param count, loss
descent, and dependent-chain throughput. Evidence that the DANN family
runs at the reference's published capacity, mirroring what
``train_flow_capacity.py`` establishes for the flow family.

Usage: python scripts/train_dann_capacity.py [--iters 40] [--batch 64]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from stainlib_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache()

import functools

import jax.numpy as jnp
import numpy as np
import optax


def parse_args(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--iters", type=int, default=40,
                   help="3-phase iterations (3 optimizer steps each)")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--invariance", action="store_true",
                   help="run the probe-toward-chance comparison at this "
                        "capacity instead of the throughput measurement")
    p.add_argument("--shortcut", action="store_true",
                   help="run the shortcut-robustness experiment (train on "
                        "95%%-tint-correlated data, test anti-correlated)")
    p.add_argument("--hp-lambda", type=float, default=2.0)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--stripe-contrast", type=float, default=None,
                   help="stripe contrast (tint cue only; default 0.03)")
    p.add_argument("--noise", type=float, default=None,
                   help="pixel noise sigma (default: 0.18 tint, 0.02 stain)")
    p.add_argument("--domain-cue", choices=("tint", "stain"), default="tint",
                   help="'tint': two_domain_task's global channel multiplier"
                        " (trivially readable); 'stain': stain_domain_task's"
                        " hue-rotated H&E recipes at matched brightness")
    p.add_argument("--stripe-amp", type=float, default=None,
                   help="H-concentration stripe modulation (stain cue only;"
                        " default 0.35)")
    p.add_argument("--lr", type=float, default=0.01)
    args = p.parse_args(argv)
    # Per-cue defaults, and a hard error instead of silently ignoring a
    # knob that belongs to the other cue's generator.
    if args.domain_cue == "stain":
        if args.stripe_contrast is not None:
            p.error("--stripe-contrast is a tint-cue knob; with "
                    "--domain-cue stain use --stripe-amp")
        args.noise = 0.02 if args.noise is None else args.noise
        args.stripe_amp = 0.35 if args.stripe_amp is None else args.stripe_amp
    else:
        if args.stripe_amp is not None:
            p.error("--stripe-amp is a stain-cue knob; with "
                    "--domain-cue tint use --stripe-contrast")
        args.noise = 0.18 if args.noise is None else args.noise
        args.stripe_contrast = (0.03 if args.stripe_contrast is None
                                else args.stripe_contrast)
    return args


def _train_phases(model, phases, X, y, d, iters, batch, seed, tx=None):
    """Phase-list training loop for an arbitrary two-headed model (the
    MobileNet capacity variant of ``train_dann.train_dann_phases``, which
    constructs the 63x63 DannCNN).

    The dataset is staged in device memory ONCE and each iteration's batch
    is gathered on-device inside the jitted step, so no per-iteration
    host->device batch transfer (38 MB at 224x224) sits in the step."""
    import jax.numpy as jnp
    import optax

    from stainlib_tpu.models import dann

    key = jax.random.PRNGKey(seed)
    variables = model.init(key, jnp.asarray(X[:1]), train=False)
    if tx is None:
        tx = optax.adam(1e-3)  # tcga_dann_4reps.py:112
    state = dann.DannState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        key=jax.random.fold_in(key, 1),
    )
    # Arguments, not closure captures: a closed-over device array is baked
    # into the compiled program as a constant (hundreds of MB here).
    Xd = jax.device_put(jnp.asarray(X))
    yd = jax.device_put(jnp.asarray(y))
    dd = jax.device_put(jnp.asarray(d))

    @jax.jit
    def step(state, data, idx, w_mit, w_dom, hp_lambda):
        Xa, ya, da = data
        im = jnp.take(Xa, idx, axis=0)
        ty = jnp.take(ya, idx, axis=0)
        dy = jnp.take(da, idx, axis=0)
        return dann.dann_train_step(model, tx, state, im, ty, dy,
                                    w_mit, w_dom, hp_lambda)

    rng = np.random.default_rng(seed + 100)
    for _ in range(iters):
        idx = jnp.asarray(rng.integers(0, len(X), batch))
        for ph in phases:
            state, _ = step(state, (Xd, yd, dd), idx, *ph)
    return state


def _best_of_reps(args, model, name, phases, iters, reps, train, val, ext):
    """The demo's selection protocol at capacity: ``reps`` repetitions,
    each train -> BN recalibration -> held-out val, keep the best by TASK
    F1 (``base_experiment_dann.py:117-125`` semantics; never by domain
    accuracy), then evaluate the winner once on the external set."""
    from stainlib_tpu.models import dann
    from stainlib_tpu.models.train_dann import (
        eval_task_domain,
        recalibrate_batch_stats,
    )

    X, y, d = train
    best_state, best_f1 = None, -1.0
    for rep in range(reps):
        tx = dann.make_dann_optimizer(args.lr)
        state = _train_phases(model, phases, X, y, d, iters,
                              args.batch, args.seed + 31 * rep, tx=tx)
        state = recalibrate_batch_stats(model, state, X[:512],
                                        batch_size=args.batch)
        v = eval_task_domain(model, state, *val, batch_size=args.batch)
        print(f"{name} rep {rep}: val {json.dumps(v)}", flush=True)
        if v["task_f1"] > best_f1:
            best_state, best_f1 = state, v["task_f1"]
    res = eval_task_domain(model, best_state, *ext, batch_size=args.batch)
    print(name, "external", json.dumps(res), flush=True)
    return res


def run_invariance(args):
    """Probe-toward-chance at the TCGA capacity (224x224 MobileNet trunk):
    the non-adversarial two-head model's live-trained domain head reads the
    tint; the 3-phase DANN loop (``tcga_dann_4reps.py:140-168``) must push
    it toward chance while task accuracy holds — the experiment of
    ``scripts/dann_invariance_demo.py`` at the published model scale.

    Uses the demo's proven protocol (see its module docstring): the
    per-layer-LR SGD of ``keras_utils.py:261-328`` (the optimizer the
    reference BUILT for this, ``tcga_dann_4reps.py:107-110`` — it compiled
    Adam only because the multipliers 'don't work deterministically' in
    Keras), BN momentum 0.9 for short runs, and best-of-``--reps``
    selection by held-out TASK F1 (``base_experiment_dann.py:117-125``
    semantics; never by domain accuracy). Measured outcomes of this
    script: Adam 1e-3 drives the probe to 1.0 at any scale (adaptive
    per-parameter scaling neutralizes the reversed gradient, so the SGD
    recipe is load-bearing); with ``--domain-cue stain --size 64`` the
    probe goes 1.000 -> chance with task F1 1.0 (the positive result on
    this trunk), while at 224x224 the cue-vs-capacity boundary holds."""
    from stainlib_tpu.data.synthetic import stain_domain_task, two_domain_task
    from stainlib_tpu.models import dann
    from stainlib_tpu.models.backbones import MobileNetDann

    model = MobileNetDann(n_domains=2, alpha=0.5, bn_momentum=0.9)

    def mk(n, seed):
        if args.domain_cue == "stain":
            return stain_domain_task(n, seed=seed, size=args.size,
                                     correlation=0.5,
                                     stripe_amp=args.stripe_amp,
                                     noise=args.noise)
        return two_domain_task(n, seed=seed, size=args.size,
                               correlation=0.5,
                               stripe_contrast=args.stripe_contrast,
                               noise=args.noise)

    train = mk(args.n_train, args.seed)
    val = mk(192, args.seed + 2)
    ext = mk(256, args.seed + 1)

    results = {}
    for name, phases, reps in [
        ("probe", [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN], 1),
        ("dann", [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN,
                  dann.phase_adversarial(args.hp_lambda)], args.reps),
    ]:
        results[name] = _best_of_reps(args, model, name, phases, args.iters,
                                      reps, train, val, ext)

    out = {
        "size": args.size,
        "iters": args.iters,
        "probe_domain_acc": round(results["probe"]["domain_acc"], 3),
        "dann_domain_acc": round(results["dann"]["domain_acc"], 3),
        "probe_task_f1": round(results["probe"]["task_f1"], 3),
        "dann_task_f1": round(results["dann"]["task_f1"], 3),
    }
    print(json.dumps(out), flush=True)
    return out


def run_shortcut(args):
    """Shortcut robustness at the TCGA capacity — the experiment that maps
    onto the reference's actual published claim (better EXTERNAL-test task
    performance via DANN, ``tcga_dann_4reps.py`` internal/external split):
    tint 95%-correlated with the task at train time, anti-correlated at
    test. A plain task-only model latches onto the tint and collapses on
    the external set; the 3-phase DANN loop must hold task F1 there.
    Baseline is compute-matched (3x iterations of the single phase)."""
    from stainlib_tpu.data.synthetic import stain_domain_task, two_domain_task
    from stainlib_tpu.models import dann
    from stainlib_tpu.models.backbones import MobileNetDann

    model = MobileNetDann(n_domains=2, alpha=0.5, bn_momentum=0.9)

    def mk(n, seed, corr):
        if args.domain_cue == "stain":
            return stain_domain_task(n, seed=seed, size=args.size,
                                     correlation=corr,
                                     stripe_amp=args.stripe_amp,
                                     noise=args.noise)
        return two_domain_task(n, seed=seed, size=args.size,
                               correlation=corr,
                               stripe_contrast=args.stripe_contrast,
                               noise=args.noise)

    train = mk(args.n_train, args.seed, 0.95)
    val = mk(192, args.seed + 2, 0.95)
    ext = mk(256, args.seed + 1, 0.0)

    results = {}
    for name, phases, iters in [
        ("baseline", [dann.PHASE_MITOSIS], args.iters * 3),
        ("dann", [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN,
                  dann.phase_adversarial(args.hp_lambda)], args.iters),
    ]:
        results[name] = _best_of_reps(args, model, name, phases, iters,
                                      args.reps, train, val, ext)

    out = {
        "size": args.size,
        "iters": args.iters,
        "baseline_external_f1": round(results["baseline"]["task_f1"], 3),
        "dann_external_f1": round(results["dann"]["task_f1"], 3),
        "baseline_external_acc": round(results["baseline"]["task_acc"], 3),
        "dann_external_acc": round(results["dann"]["task_acc"], 3),
    }
    print(json.dumps(out), flush=True)
    return out


def run(args):
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    if args.invariance:
        return run_invariance(args)
    if args.shortcut:
        return run_shortcut(args)
    from stainlib_tpu.data.synthetic import two_domain_task
    from stainlib_tpu.models import dann
    from stainlib_tpu.models.backbones import MobileNetBackbone, MobileNetDann

    key = jax.random.PRNGKey(args.seed)
    model = MobileNetDann(n_domains=2, alpha=0.5)
    x0 = jnp.zeros((1, args.size, args.size, 3), jnp.float32)
    variables = model.init(key, x0, train=False)

    trunk = MobileNetBackbone(alpha=0.5).init(key, x0, train=False)
    n_trunk = sum(int(p.size) for p in jax.tree.leaves(trunk["params"]))
    n_stats = sum(int(p.size) for p in jax.tree.leaves(trunk["batch_stats"]))
    n_total = sum(int(p.size) for p in jax.tree.leaves(variables["params"]))
    assert n_trunk + n_stats == 829_536, (n_trunk, n_stats)

    tx = optax.adam(1e-3)  # tcga_dann_4reps.py:112 (Adam lr=0.001)
    state = dann.DannState(
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        key=jax.random.fold_in(key, 1),
    )
    step = jax.jit(functools.partial(dann.dann_train_step, model, tx))

    X, y, d = two_domain_task(args.n_train, seed=args.seed, size=args.size,
                              correlation=0.5)
    X = jnp.asarray(X)
    y = jnp.asarray(y)
    d = jnp.asarray(d)
    nb = args.n_train // args.batch

    def batch(i):
        s = (i % nb) * args.batch
        return (X[s:s + args.batch], y[s:s + args.batch], d[s:s + args.batch])

    # The reference's per-iteration phase triple (tcga_dann_4reps.py:140-168).
    phases = [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN, dann.PHASE_ADVERSARIAL]

    # Warm up / compile all three phase weightings (one compiled fn).
    t0 = time.time()
    for ph in phases:
        xb, yb, db = batch(0)
        state, _ = step(state, xb, yb, db, *ph)
    jax.block_until_ready(state.params)
    compile_s = time.time() - t0

    # Losses stay ON DEVICE inside the timed loop — a per-iteration
    # float() fetch would serialize a host round trip into every step.
    losses = []
    t0 = time.time()
    for i in range(args.iters):
        for ph in phases:
            xb, yb, db = batch(i)
            state, loss = step(state, xb, yb, db, *ph)
            losses.append(loss["loss_mit"])  # device values; state chains
    jax.block_until_ready(state.params)
    dt = time.time() - t0
    steps = args.iters * 3
    imgs = steps * args.batch

    losses = [[float(v) for v in losses[i : i + 3]]
              for i in range(0, len(losses), 3)]
    for i in range(0, args.iters, 10):
        print(f"iter {i}: task {losses[i][0]:.4f} dom {losses[i][1]:.4f} "
              f"adv {losses[i][2]:.4f}", flush=True)
    head = np.mean([l[0] for l in losses[:5]])
    tail = np.mean([l[0] for l in losses[-5:]])
    out = {
        "trunk_params_plus_stats": n_trunk + n_stats,
        "model_params": n_total,
        "batch": args.batch,
        "size": args.size,
        "compile_s": round(compile_s, 1),
        "opt_steps_per_s": round(steps / dt, 2),
        "imgs_per_s": round(imgs / dt, 1),
        "task_loss_first5": round(float(head), 4),
        "task_loss_last5": round(float(tail), 4),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    run(parse_args(sys.argv[1:]))
