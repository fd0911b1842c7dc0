"""DANN experiment driver: 3-phase alternating schedule over repetitions.

Parity with ``base_experiment_dann.py:78-134`` / ``tupac_dann_4reps.py:
92-168``: per repetition, (1) a mitosis-branch warmup, (2) epochs of
1000 iterations alternating mitosis / domain / adversarial updates,
(3) per-epoch validation with macro-F1 threshold sweep keeping the best
parameters, (4) internal + external test at the best threshold; aggregated
mean/std over repetitions and CSV metric dumps
(``tupac_dann_4reps.py:163-168``). The three phases run on ONE compiled
step (scalar phase weights), and batches stream from caller-provided
iterators, so the loop body is entirely on-device.
"""

from __future__ import annotations

import csv
import dataclasses
import os
from typing import Callable, Iterator, Optional

import jax
import numpy as np

from stainlib_tpu.models import dann
from stainlib_tpu.models.evaluation import evaluate_test, evaluate_validation


@dataclasses.dataclass
class DannConfig:
    """Union of the reference knobs (``utils/config.py:1-16`` + script args)."""

    n_domains: int = 8
    lr: float = 0.01
    num_reps: int = 4
    num_epochs: int = 5
    iters_per_epoch: int = 1000
    warmup_iters: int = 20
    batch_size: int = 64
    out_dir: Optional[str] = None


def train_dann_experiment(
    cfg: DannConfig,
    mitosis_batches: Iterator,
    domain_batches: Iterator,
    val_data,
    test_internal,
    test_external,
    seed: int = 0,
    log: Callable[[str], None] = print,
):
    """Run the full repetition experiment.

    ``mitosis_batches`` / ``domain_batches`` yield (images, mit_labels,
    dom_labels) numpy batches (the balanced generators of
    ``utils_patches.py:54-305`` live in :mod:`stainlib_tpu.data.generators`).
    ``val_data`` / ``test_*`` are (images, labels) tuples.

    Returns (aggregated, per_rep) where aggregated = mean/std over reps of
    [auc_int, f1_int, auc_ext, f1_ext].
    """
    measures = []
    for rep in range(cfg.num_reps):
        log(f"================= TRAINING REPETITION {rep} =================")
        key = jax.random.PRNGKey(seed + rep)
        model, state, tx = dann.init_dann(
            key, n_domains=cfg.n_domains, lr=cfg.lr
        )
        step = dann.make_train_step(model, tx)
        predict = jax.jit(
            lambda st, x: dann.predict_mitosis(model, st, x)
        )

        best = {"f1": -1.0, "thres": 0.5, "auc": 0.0, "state": state}

        # Mitosis warmup (tupac_dann_4reps.py:106-113).
        for _ in range(cfg.warmup_iters):
            imgs, mit_y, dom_y = next(mitosis_batches)
            state, _ = step(state, imgs, mit_y, dom_y, *dann.PHASE_MITOSIS)

        for epoch in range(cfg.num_epochs):
            for _ in range(cfg.iters_per_epoch):
                imgs, mit_y, dom_y = next(mitosis_batches)
                state, m = step(state, imgs, mit_y, dom_y, *dann.PHASE_MITOSIS)
                imgs, mit_y, dom_y = next(domain_batches)
                state, m = step(state, imgs, mit_y, dom_y, *dann.PHASE_DOMAIN)
                imgs, mit_y, dom_y = next(mitosis_batches)
                state, m = step(
                    state, imgs, mit_y, dom_y, *dann.PHASE_ADVERSARIAL
                )

            thres, f1, auc = evaluate_validation(
                lambda x: predict(state, x), *val_data,
                batch_size=cfg.batch_size,
            )
            log(f"rep {rep} epoch {epoch}: val f1={f1:.4f} auc={auc:.4f}")
            # Keep the best-F1 parameters (checkpoint-best channel,
            # base_experiment_dann.py:120-125).
            if f1 > best["f1"]:
                best = {"f1": f1, "thres": thres, "auc": auc, "state": state}

        state = best["state"]
        auc_i, f1_i = evaluate_test(
            lambda x: predict(state, x), *test_internal, best["thres"],
            batch_size=cfg.batch_size,
        )
        auc_e, f1_e = evaluate_test(
            lambda x: predict(state, x), *test_external, best["thres"],
            batch_size=cfg.batch_size,
        )
        measures.append([auc_i, f1_i, auc_e, f1_e])
        log(f"rep {rep}: int auc/f1 {auc_i:.4f}/{f1_i:.4f} "
            f"ext auc/f1 {auc_e:.4f}/{f1_e:.4f}")

    measures = np.asarray(measures)
    aggregated = np.stack([measures.mean(0), measures.std(0)])

    if cfg.out_dir:
        os.makedirs(cfg.out_dir, exist_ok=True)
        for name, arr in [("measures_dann.csv", measures),
                          ("AGG_measures_dann.csv", aggregated)]:
            with open(os.path.join(cfg.out_dir, name), "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["auc_int", "f1_int", "auc_ext", "f1_ext"])
                w.writerows(arr.tolist())
    return aggregated, measures


# ---------------------------------------------------------------------------
# Invariance demonstration helpers
# ---------------------------------------------------------------------------


def train_dann_phases(images, task_labels, domain_labels, phases, iters,
                      batch_size=48, seed=0, lr=0.01, bn_momentum=0.9,
                      n_domains=2):
    """Train a :class:`~stainlib_tpu.models.dann.DannCNN` with an explicit
    per-iteration phase list (each a ``(w_mit, w_dom, hp_lambda)`` triple).

    The building block of the invariance demonstration: ``phases =
    [PHASE_MITOSIS]`` is the plain baseline, ``[PHASE_MITOSIS, PHASE_DOMAIN]``
    the non-adversarial two-head model (the domain head acts as a live probe
    of how much domain information the shared features carry), and
    ``[PHASE_MITOSIS, PHASE_DOMAIN, phase_adversarial(lam)]`` the full DANN
    loop of ``base_experiment_dann.py:87-110``. ``bn_momentum`` defaults to
    0.9 (not the reference's Keras 0.99) because demonstration runs are a few
    hundred steps, too short for 0.99 running statistics to track.

    Returns ``(model, state)``.
    """
    import jax.numpy as jnp

    model, state, tx = dann.init_dann(
        jax.random.PRNGKey(seed), n_domains=n_domains, lr=lr,
        input_shape=images.shape[1:], bn_momentum=bn_momentum,
    )
    step = dann.make_train_step(model, tx)
    rng = np.random.default_rng(seed + 100)
    for _ in range(iters):
        idx = rng.integers(0, len(images), batch_size)
        im = jnp.asarray(images[idx])
        ty = jnp.asarray(task_labels[idx])
        dy = jnp.asarray(domain_labels[idx])
        for ph in phases:
            state, _ = step(state, im, ty, dy, *ph)
    return model, state


def eval_task_domain(model, state, images, task_labels, domain_labels,
                     batch_size=128):
    """Inference-mode task accuracy/F1 and domain-head accuracy.

    The domain-head number is the invariance criterion: it is TRAINED every
    iteration (phase 2), so if it still cannot beat chance the shared
    features carry no usable domain signal (``base_experiment_dann.py``'s
    stated goal)."""
    import jax.numpy as jnp

    # One jitted dispatch per batch instead of an eager op-by-op apply.
    @jax.jit
    def infer(variables, im):
        ml, dl = model.apply(variables, im, train=False)
        return ml.argmax(-1), dl.argmax(-1)

    variables = {"params": state.params, "batch_stats": state.batch_stats}
    preds, dpreds = [], []
    for i in range(0, len(images), batch_size):
        mp, dp = infer(variables, jnp.asarray(images[i : i + batch_size]))
        preds.append(np.asarray(mp))
        dpreds.append(np.asarray(dp))
    pred = np.concatenate(preds)
    dpred = np.concatenate(dpreds)
    tp = int(((pred == 1) & (task_labels == 1)).sum())
    fp = int(((pred == 1) & (task_labels == 0)).sum())
    fn = int(((pred == 0) & (task_labels == 1)).sum())
    return {
        "task_acc": float((pred == task_labels).mean()),
        "task_f1": 2.0 * tp / max(2 * tp + fp + fn, 1),
        "domain_acc": float((dpred == domain_labels).mean()),
    }


def recalibrate_batch_stats(model, state, images, batch_size=64, passes=2,
                            key=None):
    """Recompute BatchNorm running statistics with frozen parameters.

    Short demonstration runs leave the running averages lagging the final
    parameters (inference-mode predictions then disagree wildly with
    train-mode ones); a couple of frozen-parameter passes over the training
    set converge them. Returns the state with refreshed ``batch_stats``.
    """
    import jax.numpy as jnp

    if key is None:
        key = jax.random.PRNGKey(0)

    @jax.jit
    def one_pass(params, bs, im, k):
        _, upd = model.apply(
            {"params": params, "batch_stats": bs}, im, train=True,
            rngs={"dropout": k}, mutable=["batch_stats"],
        )
        return upd["batch_stats"]

    bs = state.batch_stats
    n_full = len(images) // batch_size * batch_size
    for p in range(passes):
        for i in range(0, n_full, batch_size):
            bs = one_pass(state.params, bs,
                          jnp.asarray(images[i : i + batch_size]),
                          jax.random.fold_in(key, p * 10000 + i))
    return state._replace(batch_stats=bs)
