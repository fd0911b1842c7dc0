"""Stain-adversarial DANN models (flax) with gradient reversal.

JAX re-design of ``dlmodels/stain_adversarial_learning`` (Keras/TF1):

* gradient reversal: the TF1 ``gradient_override_map`` hack
  (``models_code/models_keras.py:138-180``) becomes a ``jax.custom_vjp``;
* ``dann_mitosis_model`` (``models_keras.py:42-86``): 63x63x3 CNN, three
  conv blocks of 16 4x4 filters with batch-norm/max-pool/dropout, a
  2-way mitosis head and an N-domain head fed through gradient reversal;
* ``mitosis_model`` baseline (``models_keras.py:90-134``);
* the 3-phase alternating schedule of ``tupac_dann_4reps.py:117-146``
  (mitosis step, domain step, adversarial step) — instead of mutating
  Keras ``K.variable`` loss weights between ``train_on_batch`` calls, ONE
  jitted train step takes ``(w_mit, w_dom, hp_lambda)`` as array arguments,
  so all three phases share a single compiled executable;
* per-layer learning rates (``LR_SGD``, ``utils/keras_utils.py:261-328``)
  via ``optax.multi_transform`` with a 0.25x multiplier on the domain head.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax


# --------------------------------------------------------------------------
# Gradient reversal
# --------------------------------------------------------------------------


@jax.custom_vjp
def gradient_reversal(x, hp_lambda):
    """Identity forward; backward multiplies the gradient by ``-hp_lambda``
    (``reverse_gradient``, ``models_keras.py:138-155``). ``hp_lambda`` is a
    traced scalar, so the adversarial schedule needs no recompilation."""
    return x


def _gr_fwd(x, hp_lambda):
    return x, hp_lambda


def _gr_bwd(hp_lambda, g):
    return (-hp_lambda * g, jnp.zeros_like(hp_lambda))


gradient_reversal.defvjp(_gr_fwd, _gr_bwd)


# --------------------------------------------------------------------------
# Models
# --------------------------------------------------------------------------


class DannCNN(nn.Module):
    """Two-headed mitosis/domain CNN (``dann_mitosis_model``,
    ``models_keras.py:42-86``). Returns (mitosis_logits, domain_logits);
    softmax lives in the loss (numerically better than the reference's
    in-graph softmax, same objective)."""

    n_domains: int = 8
    n_filters: int = 16
    # Keras BatchNormalization default (reference parity). Short demo runs
    # (a few hundred steps) should pass ~0.9 so the inference-mode running
    # statistics can track the still-moving feature distribution.
    bn_momentum: float = 0.99

    @nn.compact
    def __call__(self, x, hp_lambda=1.0, train: bool = True):
        conv = functools.partial(
            nn.Conv, features=self.n_filters, kernel_size=(4, 4),
            padding="VALID", kernel_init=nn.initializers.glorot_uniform(),
        )
        norm = functools.partial(
            nn.BatchNorm, use_running_average=not train,
            momentum=self.bn_momentum,
        )
        # Block 1: conv, conv, BN, pool.
        x = nn.relu(conv()(x))
        x = nn.relu(conv()(x))
        x = norm()(x)
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        # Block 2: conv, BN, pool, dropout.
        x = nn.relu(conv()(x))
        x = norm()(x)
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = nn.Dropout(0.25, deterministic=not train)(x)
        # Block 3.
        x = nn.relu(conv()(x))
        x = norm()(x)
        x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = nn.Dropout(0.25, deterministic=not train)(x)

        feats = x.reshape((x.shape[0], -1))

        # Domain head behind gradient reversal.
        xd = gradient_reversal(feats, jnp.asarray(hp_lambda, x.dtype))
        xd = nn.relu(nn.Dense(128, name="dom_pred_feats1")(xd))
        xd = nn.relu(nn.Dense(128, name="dom_pred_feats2")(xd))
        domain_logits = nn.Dense(self.n_domains, name="dom_regressor")(xd)

        # Mitosis head.
        xm = nn.relu(nn.Dense(128, name="mit_pred_feats1")(feats))
        xm = nn.relu(nn.Dense(128, name="mit_pred_feats2")(xm))
        xm = norm(name="mit_bn")(xm)
        xm = nn.relu(xm)
        xm = nn.Dropout(0.25, deterministic=not train)(xm)
        mitosis_logits = nn.Dense(2, name="mit_pred")(xm)
        return mitosis_logits, domain_logits


class BaselineCNN(nn.Module):
    """Sequential mitosis classifier (``mitosis_model``,
    ``models_keras.py:90-134``)."""

    n_filters: int = 16

    @nn.compact
    def __call__(self, x, train: bool = True):
        conv = functools.partial(
            nn.Conv, features=self.n_filters, kernel_size=(4, 4),
            padding="VALID",
        )
        norm = functools.partial(
            nn.BatchNorm, use_running_average=not train, momentum=0.99
        )
        x = nn.relu(conv()(x))
        for _ in range(3):
            x = nn.relu(conv()(x))
            x = norm()(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
            x = nn.Dropout(0.25, deterministic=not train)(x)
        x = x.reshape((x.shape[0], -1))
        x = norm()(nn.Dense(128)(x))
        x = nn.relu(x)
        x = nn.Dropout(0.25, deterministic=not train)(x)
        return nn.Dense(2)(x)


# --------------------------------------------------------------------------
# Optimizer: per-layer learning rates
# --------------------------------------------------------------------------


def make_dann_optimizer(lr: float = 0.01, momentum: float = 0.9,
                        dom_lr_multiplier: float = 0.25,
                        nesterov: bool = True) -> optax.GradientTransformation:
    """SGD with a reduced LR on the domain head.

    Parity with ``LR_SGD`` (``keras_utils.py:261-328``), which multiplies the
    LR by 0.25 for layers named 'dom_regressor' — here via
    ``optax.multi_transform`` keyed on the parameter path.
    """

    def label_fn(params):
        def label(path, _):
            names = [getattr(k, "key", "") for k in path]
            is_dom = any(isinstance(n, str) and n == "dom_regressor"
                         for n in names)
            return "dom" if is_dom else "main"

        return jax.tree_util.tree_map_with_path(label, params)

    return optax.multi_transform(
        {
            "main": optax.sgd(lr, momentum=momentum, nesterov=nesterov),
            "dom": optax.sgd(lr * dom_lr_multiplier, momentum=momentum,
                             nesterov=nesterov),
        },
        label_fn,
    )


# --------------------------------------------------------------------------
# Training step + 3-phase schedule
# --------------------------------------------------------------------------


class DannState(NamedTuple):
    params: Any
    batch_stats: Any
    opt_state: Any
    key: jax.Array


def init_dann(key, n_domains: int = 8, lr: float = 0.01,
              input_shape=(63, 63, 3),
              bn_momentum: float = 0.99) -> tuple[DannCNN, DannState, Any]:
    model = DannCNN(n_domains=n_domains, bn_momentum=bn_momentum)
    k_init, k_state = jax.random.split(key)
    variables = model.init(
        k_init, jnp.zeros((1,) + input_shape, jnp.float32), train=False
    )
    tx = make_dann_optimizer(lr)
    state = DannState(
        params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        key=k_state,
    )
    return model, state, tx


def dann_train_step(model: DannCNN, tx, state: DannState, images,
                    mit_labels, dom_labels, w_mit, w_dom, hp_lambda):
    """One weighted step; the three phases of ``tupac_dann_4reps.py:117-146``
    are (w_mit, w_dom, hp_lambda) = (1,0,0), (0,1,-1), (1,1,1) on the SAME
    compiled function. Labels are int class ids."""

    def loss_fn(params):
        (mit_logits, dom_logits), updates = model.apply(
            {"params": params, "batch_stats": state.batch_stats},
            images, hp_lambda=hp_lambda, train=True,
            rngs={"dropout": jax.random.fold_in(state.key, 0)},
            mutable=["batch_stats"],
        )
        l_mit = optax.softmax_cross_entropy_with_integer_labels(
            mit_logits, mit_labels
        ).mean()
        l_dom = optax.softmax_cross_entropy_with_integer_labels(
            dom_logits, dom_labels
        ).mean()
        return w_mit * l_mit + w_dom * l_dom, (l_mit, l_dom, updates)

    (loss, (l_mit, l_dom, updates)), grads = jax.value_and_grad(
        loss_fn, has_aux=True
    )(state.params)
    updates_tx, opt_state = tx.update(grads, state.opt_state, state.params)
    params = optax.apply_updates(state.params, updates_tx)
    new_state = DannState(
        params=params,
        batch_stats=updates["batch_stats"],
        opt_state=opt_state,
        key=jax.random.fold_in(state.key, 1),
    )
    return new_state, {"loss": loss, "loss_mit": l_mit, "loss_dom": l_dom}


def make_train_step(model: DannCNN, tx):
    """Jit once; run every phase with scalar weights (no recompiles)."""
    return jax.jit(functools.partial(dann_train_step, model, tx))


def reinit_layers(params, layer_names, key, scale: float = 0.05):
    """Re-initialize the parameters of named top-level layers.

    Parity with ``reset_weights`` (``utils/keras_utils.py:254-258``), which
    re-runs initializers on chosen Keras layers; here kernels redraw from a
    truncated normal and biases zero, keyed explicitly."""
    import numpy as np

    flat = dict(params)
    for i, name in enumerate(layer_names):
        if name not in flat:
            continue
        sub = dict(flat[name])
        for j, (k, v) in enumerate(sorted(sub.items())):
            if k.startswith("bias"):
                sub[k] = jnp.zeros_like(v)
            else:
                sub[k] = scale * jax.random.truncated_normal(
                    jax.random.fold_in(key, i * 131 + j), -2.0, 2.0,
                    v.shape, v.dtype,
                )
        flat[name] = sub
    return flat


PHASE_MITOSIS = (1.0, 0.0, 0.0)
PHASE_DOMAIN = (0.0, 1.0, -1.0)
PHASE_ADVERSARIAL = (1.0, 1.0, 1.0)


def phase_adversarial(hp_lambda: float = 1.0):
    """Adversarial phase weights with an explicit reversal strength.

    The reference fixes hp_lambda=1 in the adversarial update but carries a
    ``lambda_m`` config knob and a commented-out adaptive schedule
    ``(2/(1+exp(-20 iter/change_iter)))-1`` (``base_experiment_dann.py:
    104-106``). Note the schedule's structural property: the domain phase
    pushes +1x the domain gradient INTO the shared features and the
    adversarial phase pushes -hp_lambda x, so at hp_lambda=1 the net
    first-order pressure on the features cancels and invariance emerges only
    slowly; hp_lambda ~ 2 makes the net pressure strictly adversarial (used
    by the invariance demonstration, ``scripts/dann_invariance_demo.py``)."""
    return (1.0, 1.0, float(hp_lambda))


def predict_mitosis(model: DannCNN, state: DannState, images):
    """Inference-mode mitosis class probabilities (softmax over 2)."""
    mit_logits, _ = model.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        images, train=False,
    )
    return jax.nn.softmax(mit_logits, axis=-1)


def predict_domain(model: DannCNN, state: DannState, images):
    """Inference-mode domain class probabilities from the adversarial head.

    Under successful adversarial training this head's accuracy on held-out
    data degrades toward chance — the stain-invariance criterion of
    ``base_experiment_dann.py:78-134``."""
    _, dom_logits = model.apply(
        {"params": state.params, "batch_stats": state.batch_stats},
        images, train=False,
    )
    return jax.nn.softmax(dom_logits, axis=-1)
