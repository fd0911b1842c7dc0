"""Residual flow: invertible ResNet blocks with tractable log-determinant.

JAX counterpart of the color-information model's ``lib.resflow.
ResidualFlow`` (constructed at ``train_img_horo.py:324-358``; behavior per
the Residual Flows paper cited in ``dlmodels/color-information/README.md``).
Structure: LogitTransform init layer -> per-scale [ActNorm -> iResBlock]*k
with squeeze between scales.

Log-det design: the reference uses a *stochastic* power series with
geometric-distributed truncation and Neumann-series gradients (flags at
``train_img_horo.py:91-98``) — dynamic-length loops hostile to XLA. Here the
Hutchinson power series has a FIXED truncation (``n_power_series``) computed
with repeated jvp under ``lax.scan``: deterministic shapes, one compile,
remat-friendly. The truncation bias is controlled by the blocks' Lipschitz
budget (coeff^k decay) and is irrelevant to the NMI/bpd metrics at the
depths used; an exact brute-force Jacobian mode is provided for testing
(the reference's ``train_toy.py`` 'brute-force logdet' option).
"""

from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from stainlib_tpu.models.flow_layers import (
    ActNorm,
    LipschitzNet,
    LogitTransform,
    squeeze,
    unsqueeze,
)


class IResBlock(nn.Module):
    """y = x + g(x) with contractive g; Hutchinson power-series logdet."""

    hidden: int = 64
    n_layers: int = 3
    coeff: float = 0.98
    n_power_series: int = 6
    n_probes: int = 1
    n_fixed_point_iters: int = 40
    input_shape: Sequence[int] = ()
    kernel_sizes: Sequence[int] = (3, 3, 3)
    remat_logdet: bool = False

    def setup(self):
        self.g = LipschitzNet(
            hidden=self.hidden, n_layers=self.n_layers, coeff=self.coeff,
            input_shape=self.input_shape, kernel_sizes=self.kernel_sizes,
        )

    def __call__(self, x, key, update: bool = False,
                 exact_logdet: bool = False, skip_logdet: bool = False):
        # Power-iteration state may only mutate in this direct call — never
        # inside the logdet scan/jvp (illegal variable write under lax.scan).
        y = x + self.g(x, update=update)
        if skip_logdet:
            # Spectral-refresh path (update_lipschitz): the power iteration
            # reads only the kernels, so the Hutchinson series would be
            # computed just to be discarded.
            return y, jnp.zeros((x.shape[0],), x.dtype)
        g_fn = lambda v: self.g(v, update=False)
        if exact_logdet:
            logdet = _exact_logdet(g_fn, x)
        else:
            logdet = _power_series_logdet(g_fn, x, key, self.n_power_series,
                                          self.n_probes,
                                          remat=self.remat_logdet)
        return y, logdet

    def inverse(self, y):
        """Fixed-point iteration x <- y - g(x); converges geometrically for
        contractive g (banach), fixed iteration count for jit."""
        g_fn = lambda v: self.g(v, update=False)

        def body(_, x):
            return y - g_fn(x)

        return jax.lax.fori_loop(0, self.n_fixed_point_iters, body, y)


def _power_series_logdet(g_fn, x, key, n_terms, n_probes: int = 1,
                         remat: bool = False):
    """log det(I + Jg) ~ sum_k (-1)^{k+1}/k E_v[v^T Jg^k v], Hutchinson with
    Rademacher probes, fixed truncation; jvp-chained under scan and vmapped
    over probes (training uses 1 probe like the reference; tests use many).

    ``remat=True`` checkpoints the scan body: each jvp's conv intermediates
    are recomputed in the backward pass instead of being saved per series
    term — the memory-efficient-backprop role of the reference's
    ``--mem-eff`` flags (``train_img_horo.py:91-98``), required to fit the
    reference-capacity 256x256 model in HBM."""

    def single(probe_key):
        v0 = jax.random.rademacher(probe_key, x.shape, x.dtype)

        def body(carry, k):
            vk, acc = carry
            _, jv = jax.jvp(g_fn, (x,), (vk,))
            coeff = jnp.where(k % 2 == 1, 1.0, -1.0) / k.astype(x.dtype)
            term = coeff * jnp.sum(
                (jv * v0).reshape(x.shape[0], -1), axis=-1
            )
            return (jv, acc + term), None

        if remat:
            body = jax.checkpoint(body)
        ks = jnp.arange(1, n_terms + 1)
        (_, logdet), _ = jax.lax.scan(
            body, (v0, jnp.zeros((x.shape[0],), x.dtype)), ks
        )
        return logdet

    if n_probes == 1:
        return single(key)
    return jnp.mean(jax.vmap(single)(jax.random.split(key, n_probes)), axis=0)


def _exact_logdet(g_fn, x):
    """Brute-force log|det(I + Jg)| per sample (test-scale inputs only)."""
    def one(xi):
        flat = xi.reshape(-1)

        def f(v):
            return g_fn(v.reshape((1,) + xi.shape))[0].reshape(-1)

        J = jax.jacfwd(f)(flat)
        return jnp.linalg.slogdet(jnp.eye(flat.size) + J)[1]

    return jax.vmap(one)(x)


class ResidualFlow(nn.Module):
    """Multi-scale residual flow over NHWC images in [0, 1].

    forward: x -> (z, delta_logp) where delta_logp = -sum logdet
    (the sign convention of ``compute_loss``: ``logpx = logpz - delta_logp
    - ...``, ``train_img_horo.py:466-501``).
    """

    n_scales: int = 2
    blocks_per_scale: int = 4
    hidden: int = 64
    coeff: float = 0.98
    n_power_series: int = 6
    input_shape: Sequence[int] = (32, 32, 1)  # (H, W, C) at the input
    squeeze_first: bool = False
    logit_alpha: float = 1e-5
    kernel_sizes: Sequence[int] = (3, 3, 3)
    remat_logdet: bool = False

    def setup(self):
        self.init_layer = LogitTransform(alpha=self.logit_alpha)
        h, w, c = self.input_shape
        if self.squeeze_first:
            h, w, c = h // 2, w // 2, c * 4
        scales = []
        norms = []
        for s in range(self.n_scales):
            blocks = []
            bnorms = []
            for b in range(self.blocks_per_scale):
                blocks.append(
                    IResBlock(
                        hidden=self.hidden, coeff=self.coeff,
                        n_power_series=self.n_power_series,
                        input_shape=(h, w, c),
                        kernel_sizes=self.kernel_sizes,
                        remat_logdet=self.remat_logdet,
                    )
                )
                bnorms.append(ActNorm())
            scales.append(blocks)
            norms.append(bnorms)
            if s != self.n_scales - 1:
                h, w, c = h // 2, w // 2, c * 4
        self.scales = scales
        self.norms = norms

    def __call__(self, x, key, update: bool = False,
                 exact_logdet: bool = False, skip_logdet: bool = False):
        B = x.shape[0]
        logdet = jnp.zeros((B,), x.dtype)
        y, ld = self.init_layer(x)
        logdet += ld
        if self.squeeze_first:
            y = squeeze(y)
        for s in range(self.n_scales):
            for b in range(self.blocks_per_scale):
                y, ld = self.norms[s][b](y)
                logdet += ld
                key, sub = jax.random.split(key)
                y, ld = self.scales[s][b](
                    y, sub, update=update, exact_logdet=exact_logdet,
                    skip_logdet=skip_logdet,
                )
                logdet += ld
            if s != self.n_scales - 1:
                y = squeeze(y)
        return y, -logdet  # delta_logp convention

    def inverse(self, z):
        y = z
        for s in reversed(range(self.n_scales)):
            if s != self.n_scales - 1:
                y = unsqueeze(y)
            for b in reversed(range(self.blocks_per_scale)):
                y = self.scales[s][b].inverse(y)
                y, _ = self.norms[s][b](y, reverse=True)
        if self.squeeze_first:
            y = unsqueeze(y)
        y, _ = self.init_layer(y, reverse=True)
        return y


def update_lipschitz(model: ResidualFlow, variables, x, key):
    """Re-run power iteration on every spectral-norm conv (the reference's
    post-step ``update_lipschitz(model)``, ``train_img_horo.py:1089-1095``).
    Returns refreshed variables; jit-able. The power iteration is
    data-independent (it reads only the kernels), so the pass runs on a
    single batch element with the Hutchinson logdet skipped — identical
    spectral state at a fraction of the full forward's cost."""
    outs, updated = model.apply(
        variables, x[:1], key, update=True, skip_logdet=True,
        mutable=["spectral"]
    )
    del outs
    new_vars = dict(variables)
    new_vars["spectral"] = updated["spectral"]
    return new_vars
