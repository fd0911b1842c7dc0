"""Small U-Net segmenter for the cross-center transfer demonstration.

The reference's headline claim for flow-based color normalization is a
downstream one: a segmentation network trained on one CAMELYON17 center
scores higher validation mIoU when its inputs are normalized (iResFlow
0.8477 vs DCGMM 0.7928 — ``dlmodels/color-information/README.md``
"Semantic Segmentation Comparison with DCGMM" table). The reference repo
does not vendor that segmentation code (the numbers come from the paper),
so this module provides the framework's own minimal segmenter used by
``scripts/seg_transfer_demo.py`` to reproduce the *shape* of that result on
the synthetic multi-center cohort: train on the template center, deploy on
color-shifted centers, compare mIoU raw vs normalized inputs.

Layout notes: all convs are static-shape NHWC, pooling/upsampling by
factors of two, so the whole step lowers to one XLA program; batches and
spatial dims stay multiples of 8.
"""

from __future__ import annotations

import functools
from typing import Optional

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax


class UNet(nn.Module):
    """Encoder/decoder with skip connections. ``depth`` pool stages, channel
    widths ``base * 2**level``; input H/W must be divisible by
    ``2**depth``."""

    n_classes: int = 3
    base: int = 16
    depth: int = 3

    @nn.compact
    def __call__(self, x):
        def block(x, ch):
            x = nn.relu(nn.Conv(ch, (3, 3), padding="SAME")(x))
            return nn.relu(nn.Conv(ch, (3, 3), padding="SAME")(x))

        skips = []
        for lvl in range(self.depth):
            x = block(x, self.base << lvl)
            skips.append(x)
            x = nn.max_pool(x, (2, 2), strides=(2, 2))
        x = block(x, self.base << self.depth)
        for lvl in reversed(range(self.depth)):
            x = nn.ConvTranspose(self.base << lvl, (2, 2),
                                 strides=(2, 2))(x)
            x = jnp.concatenate([x, skips[lvl]], axis=-1)
            x = block(x, self.base << lvl)
        return nn.Conv(self.n_classes, (1, 1))(x)  # logits (B, H, W, K)


def mean_iou(pred: np.ndarray, labels: np.ndarray, n_classes: int) -> float:
    """Mean intersection-over-union over classes present in ``labels``
    (the standard mIoU of the reference's segmentation table)."""
    pred = np.asarray(pred).reshape(-1)
    labels = np.asarray(labels).reshape(-1)
    ious = []
    for k in range(n_classes):
        gt = labels == k
        if not gt.any():
            continue
        pk = pred == k
        inter = float(np.logical_and(gt, pk).sum())
        union = float(np.logical_or(gt, pk).sum())
        ious.append(inter / max(union, 1.0))
    return float(np.mean(ious)) if ious else float("nan")


def train_segmenter(images_u8: np.ndarray, masks: np.ndarray, *,
                    steps: int = 300, batch: int = 32, lr: float = 1e-3,
                    base: int = 16, depth: int = 3, n_classes: int = 3,
                    seed: int = 0, log=None):
    """Train a :class:`UNet` on uint8 tiles + int masks; returns
    ``(predict_fn, params)`` where ``predict_fn(uint8 batch) -> (B, H, W)
    int32 class map`` is jitted."""
    model = UNet(n_classes=n_classes, base=base, depth=depth)
    key = jax.random.PRNGKey(seed)
    x0 = jnp.asarray(images_u8[:1], jnp.float32) / 255.0
    params = model.init(key, x0)["params"]
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    @jax.jit
    def step_fn(params, opt_state, imgs, labels):
        def loss_fn(p):
            logits = model.apply({"params": p},
                                 jnp.asarray(imgs, jnp.float32) / 255.0)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, labels).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    rng = np.random.default_rng(seed)
    for i in range(steps):
        sel = rng.integers(0, len(images_u8), batch)
        params, opt_state, loss = step_fn(
            params, opt_state, jnp.asarray(images_u8[sel]),
            jnp.asarray(masks[sel]))
        if log is not None and (i % 100 == 0 or i == steps - 1):
            log(f"seg step {i}: loss {float(loss):.4f}")

    @jax.jit
    def predict(imgs_u8):
        logits = model.apply({"params": params},
                             jnp.asarray(imgs_u8, jnp.float32) / 255.0)
        return jnp.argmax(logits, axis=-1).astype(jnp.int32)

    return predict, params
