"""Invertible flow layers: ActNorm, logit transform, squeeze, Lipschitz nets.

JAX building blocks for the residual-flow color model. The reference
vendors these in an (un-checked-in) ``lib/`` package; behavior is
reconstructed from its call sites (``dlmodels/color-information/
train_img_horo.py:289,321,324-358,1089-1095``) and the Residual Flows paper
its README cites. Design departures: spectral-norm power iteration is
a *fixed-length* ``lax.fori_loop`` (not a tolerance loop) so everything jits
with static shapes, and its state (u, sigma) lives in a flax 'spectral'
variable collection updated by an explicit ``update_lipschitz`` pass —
mirroring the reference's post-step ``update_lipschitz(model)`` call.

All layers expose ``forward(x) -> (y, logdet)`` and ``inverse(y) -> x``
with NHWC layouts (channels-last, the layout XLA's convolutions take natively).
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp


class ActNorm(nn.Module):
    """Per-channel affine with data-dependent init.

    y = (x - b) * exp(logs); logdet = sum(logs) * H * W. The first forward
    initializes b/logs from batch statistics (the reference's lazy ActNorm
    materialized by a dummy forward at resume, ``train_img_horo.py:437-441``).
    """

    @nn.compact
    def __call__(self, x, reverse: bool = False):
        def b_init(key, shape):
            return jnp.mean(x, axis=(0, 1, 2)) if not reverse else jnp.zeros(shape)

        def s_init(key, shape):
            if reverse:
                return jnp.zeros(shape)
            std = jnp.std(x, axis=(0, 1, 2)) + 1e-6
            return -jnp.log(std)

        c = x.shape[-1]
        b = self.param("bias", b_init, (c,))
        logs = self.param("logs", s_init, (c,))
        hw = x.shape[-3] * x.shape[-2]
        logdet = jnp.sum(logs) * hw
        if reverse:
            return x * jnp.exp(-logs) + b, -logdet
        return (x - b) * jnp.exp(logs), logdet


class LogitTransform(nn.Module):
    """[0,1] images -> logit space (init layer, ``train_img_horo.py:289``).

    y = logit(a + (1 - 2a) x); per-pixel logdet accumulated over the image.
    """

    alpha: float = 1e-5

    def __call__(self, x, reverse: bool = False):
        a = self.alpha
        if reverse:
            s = jax.nn.sigmoid(x)
            y = (s - a) / (1.0 - 2.0 * a)
            # dx/dy = s(1-s)/(1-2a) -> logdet is the negation of forward's.
            logdet = jnp.sum(
                jnp.log(s) + jnp.log1p(-s) - jnp.log(1.0 - 2.0 * a),
                axis=(-3, -2, -1),
            )
            return y, logdet
        s = a + (1.0 - 2.0 * a) * x
        y = jnp.log(s) - jnp.log1p(-s)
        logdet = jnp.sum(
            jnp.log(1.0 - 2.0 * a) - jnp.log(s) - jnp.log1p(-s),
            axis=(-3, -2, -1),
        )
        return y, logdet


def squeeze(x):
    """Space-to-depth x2 (``SqueezeLayer``, ``train_img_horo.py:321``)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def unsqueeze(x):
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, 2, 2, c // 4)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w, c // 4)


class SpectralNormConv(nn.Module):
    """Conv whose operator norm is constrained to ``coeff``.

    Power iteration runs on the true conv operator (conv / conv-transpose
    pair) for ``n_iters`` fixed steps; u and the running sigma live in the
    'spectral' collection so the constraint can be tightened *after* each
    optimizer step (``update_lipschitz``, ``train_img_horo.py:1089-1095``)
    rather than re-estimated inside the training jit.
    """

    features: int
    kernel_size: int = 3
    coeff: float = 0.98
    n_iters: int = 1
    input_shape: Sequence[int] = ()  # (H, W, C) of this layer's input

    @nn.compact
    def __call__(self, x, update: bool = False):
        h, w, c_in = self.input_shape
        kernel = self.param(
            "kernel",
            nn.initializers.variance_scaling(1.0, "fan_in", "normal"),
            (self.kernel_size, self.kernel_size, c_in, self.features),
        )
        bias = self.param("bias", nn.initializers.zeros, (self.features,))
        u_var = self.variable(
            "spectral", "u",
            lambda: jax.random.normal(jax.random.PRNGKey(0), (1, h, w, c_in)),
        )
        sigma_var = self.variable(
            "spectral", "sigma", lambda: jnp.ones(())
        )

        def conv(v, k):
            return jax.lax.conv_general_dilated(
                v, k, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")
            )

        def conv_t(v, k):
            return jax.lax.conv_general_dilated(
                v, jnp.flip(k, (0, 1)).swapaxes(2, 3), (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
            )

        if update:
            u = u_var.value

            def power_iter(_, u):
                v = conv(u, kernel)
                v = v / (jnp.linalg.norm(v) + 1e-12)
                u = conv_t(v, kernel)
                u = u / (jnp.linalg.norm(u) + 1e-12)
                return u

            u = jax.lax.fori_loop(0, self.n_iters, power_iter, u)
            v = conv(u, kernel)
            sigma = jnp.linalg.norm(v)
            u_var.value = u
            sigma_var.value = sigma
        sigma = sigma_var.value

        # Scale only when the estimated norm exceeds the budget.
        factor = jnp.minimum(1.0, self.coeff / (sigma + 1e-12))
        k_hat = kernel * jax.lax.stop_gradient(factor)
        return conv(x, k_hat) + bias


class LipschitzNet(nn.Module):
    """The residual branch g(x): spectral-norm convs + 'swish-like' gates.

    Activation is CLipSwish-free plain ``swish/1.1`` whose Lipschitz bound
    is 1 (swish's slope is bounded by ~1.0998); combined with per-conv
    coeff the whole branch is a contraction, the iResBlock requirement.

    ``kernel_sizes`` sets the per-layer conv kernels — the reference's
    ``--kernels`` flag, default '3-1-3' (``train_img_horo.py:110``); its
    published ~500k-param model uses the 3-1-3 bottleneck.
    """

    hidden: int = 64
    n_layers: int = 3
    coeff: float = 0.98
    input_shape: Sequence[int] = ()
    kernel_sizes: Sequence[int] = (3, 3, 3)

    @nn.compact
    def __call__(self, x, update: bool = False):
        h, w, c = self.input_shape
        act = lambda v: jax.nn.swish(v) / 1.1
        y = x
        shapes = [c] + [self.hidden] * (self.n_layers - 1)
        for i, c_in in enumerate(shapes):
            c_out = c if i == self.n_layers - 1 else self.hidden
            y = SpectralNormConv(
                features=c_out, coeff=self.coeff,
                kernel_size=self.kernel_sizes[i % len(self.kernel_sizes)],
                input_shape=(h, w, c_in), name=f"conv{i}",
            )(y, update=update)
            if i != self.n_layers - 1:
                y = act(y)
        return y
