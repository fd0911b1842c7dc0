"""DANN adversarial effect: domain probe to chance, task preserved.

The round-1 gap: ``tests/test_dann.py`` verified the 3-phase mechanics but
nothing showed the adversarial objective actually producing invariance
(``base_experiment_dann.py:78-134``'s entire point). This test trains on the
synthetic spurious-cue task (stripe orientation = task, color tint = domain,
independent of each other) and asserts:

* the NON-adversarial two-head model's domain head reads the tint nearly
  perfectly — the probe works, the cue is trivially learnable;
* under the 3-phase DANN loop the SAME continuously-trained domain head
  drops far toward chance while task F1 stays high.

Protocol notes (both mirror the reference):

* Adversarial minimax runs are high-variance — individual repetitions can
  collapse. The reference runs ``numreps`` repetitions and keeps the
  best-validation-F1 checkpoint (``base_experiment_dann.py:117-125``); we do
  the same over 3 reps, selecting by TASK F1 on a held-out validation set
  (never by domain accuracy, which keeps the invariance claim honest).
  Empirically task collapse and domain-suppression failure coincide, so the
  selection rejects exactly the collapsed runs.
* hp_lambda = 2 in the adversarial phase: the reference's domain phase
  pushes +1x the domain gradient into the shared features, so lambda = 1
  cancels to first order (see ``dann.phase_adversarial``); the reference
  exposes the strength as ``lambda_m``.

CI scale (39x39); full-size numbers live in
``scripts/dann_invariance_demo.py``.
"""

import numpy as np
import pytest

from stainlib_tpu.data.synthetic import two_domain_task
from stainlib_tpu.models import dann
from stainlib_tpu.models.train_dann import (
    eval_task_domain,
    recalibrate_batch_stats,
    train_dann_phases,
)

SIZE = 39
BATCH = 32


def _trained(phases, iters, seed, Xtr, ytr, dtr):
    model, state = train_dann_phases(
        Xtr, ytr, dtr, phases, iters=iters, batch_size=BATCH, seed=seed
    )
    state = recalibrate_batch_stats(model, state, Xtr, batch_size=BATCH)
    return model, state


@pytest.mark.slow
def test_domain_probe_toward_chance_under_dann_while_task_holds():
    Xtr, ytr, dtr = two_domain_task(768, seed=0, correlation=0.5, size=SIZE)
    Xva, yva, dva = two_domain_task(256, seed=5, correlation=0.5, size=SIZE)
    Xte, yte, dte = two_domain_task(384, seed=1, correlation=0.5, size=SIZE)

    # Non-adversarial two-head model: the domain head must read the tint.
    model, state = _trained(
        [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN], 150, 1, Xtr, ytr, dtr
    )
    probe = eval_task_domain(model, state, Xte, yte, dte)
    assert probe["domain_acc"] >= 0.9, probe
    assert probe["task_f1"] >= 0.75, probe

    # Full DANN loop, 3 repetitions, keep best validation TASK F1
    # (base_experiment_dann.py:117-125's best-checkpoint channel).
    best = None
    for rep in range(3):
        model, state = _trained(
            [dann.PHASE_MITOSIS, dann.PHASE_DOMAIN,
             dann.phase_adversarial(2.0)],
            180, 50 + rep, Xtr, ytr, dtr,
        )
        val_f1 = eval_task_domain(model, state, Xva, yva, dva)["task_f1"]
        if best is None or val_f1 > best[0]:
            best = (val_f1, model, state)

    adv = eval_task_domain(best[1], best[2], Xte, yte, dte)
    assert adv["task_f1"] >= 0.85, adv
    # Chance is 0.5 for two balanced domains; the tint-reading head sat at
    # ~1.0 without the adversarial phase.
    assert adv["domain_acc"] <= 0.75, adv
    assert probe["domain_acc"] - adv["domain_acc"] >= 0.25, (probe, adv)


def test_two_domain_task_shapes_and_balance():
    X, y, d = two_domain_task(200, seed=3, correlation=0.5, size=SIZE)
    assert X.shape == (200, SIZE, SIZE, 3) and X.dtype == np.float32
    assert X.min() >= 0.0 and X.max() <= 1.0
    assert set(np.unique(y)) == {0, 1} and set(np.unique(d)) == {0, 1}
    # correlation=0.5 -> domain independent of task (roughly half match).
    assert 0.35 < (y == d).mean() < 0.65
    # The tint is a real, per-domain color shift.
    mean0 = X[d == 0].mean(axis=(0, 1, 2))
    mean1 = X[d == 1].mean(axis=(0, 1, 2))
    assert mean0[0] > mean1[0] and mean0[2] < mean1[2]
