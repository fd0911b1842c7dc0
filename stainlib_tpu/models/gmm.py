"""Deep convolutional GMM head over flow latents (DCGMM-style).

JAX counterpart of the missing ``lib.GMM.GMM_model`` (call sites
``train_img_horo.py:363,492,703-705``): a small CNN on the HSD image
produces per-pixel tissue-class responsibilities gamma (softmax over
``n_clusters``); each class k carries a learned mean mu_k and scale sigma_k
for the flow latent; the latent log-density is the per-pixel log mixture

    logpz = sum_pixels log sum_k gamma_k * N(z_pixel; mu_k, sigma_k)

Returns ``(logpz, (mu, sigma, gamma))`` exactly as the reference consumes it
(template statistics at ``train_img_horo.py:703-705``, recoloring at
``:815``).
"""

from __future__ import annotations

import flax.linen as nn
import jax
import jax.numpy as jnp


class ConvGMM(nn.Module):
    """Per-pixel mixture density over a C-channel latent field."""

    n_clusters: int = 4
    hidden: int = 32
    n_layers: int = 3
    latent_channels: int = 1

    @nn.compact
    def __call__(self, z, x_cond):
        """``z``: (B, H, W, Cz) flow latents; ``x_cond``: (B, H, W, Cc)
        conditioning image (HSD chroma in the reference pipeline).

        Returns (logpz (B,), (mu, sigma, gamma)) with
        mu/sigma shaped (n_clusters, Cz) and gamma at the LATENT grid
        (B, Hz, Wz, n_clusters). Conditioning at a finer resolution than the
        (multi-scale squeezed) latent is average-pooled down to match.
        """
        h = x_cond
        factor = x_cond.shape[1] // z.shape[1]
        if factor > 1:
            h = nn.avg_pool(h, (factor, factor), strides=(factor, factor))
        for i in range(self.n_layers - 1):
            h = nn.Conv(self.hidden, (3, 3), padding="SAME")(h)
            h = nn.relu(h)
        logits = nn.Conv(self.n_clusters, (3, 3), padding="SAME")(h)
        gamma = jax.nn.softmax(logits, axis=-1)  # (B, H, W, K)

        mu = self.param(
            "mu",
            lambda k, s: jnp.linspace(-1.0, 1.0, self.n_clusters)[:, None]
            * jnp.ones(s[1]),
            (self.n_clusters, self.latent_channels),
        )
        log_sigma = self.param(
            "log_sigma", nn.initializers.zeros,
            (self.n_clusters, self.latent_channels),
        )
        sigma = jnp.exp(log_sigma)

        # Per-pixel, per-class diagonal Gaussian log density of z.
        z_e = z[..., None, :]  # (B, H, W, 1, Cz)
        log_n = -0.5 * (
            ((z_e - mu) / sigma) ** 2
            + 2.0 * log_sigma
            + jnp.log(2.0 * jnp.pi)
        ).sum(-1)  # (B, H, W, K)
        log_mix = jax.nn.logsumexp(
            log_n + jnp.log(gamma + 1e-12), axis=-1
        )  # (B, H, W)
        logpz = jnp.sum(log_mix, axis=(-2, -1))  # (B,)
        return logpz, (mu, sigma, gamma)


def upsample_gamma(gamma, h: int, w: int):
    """Nearest-neighbor upsample of latent-grid responsibilities back to the
    image grid (for per-pixel color statistics / recoloring)."""
    fh = h // gamma.shape[1]
    fw = w // gamma.shape[2]
    if fh > 1:
        gamma = jnp.repeat(gamma, fh, axis=1)
    if fw > 1:
        gamma = jnp.repeat(gamma, fw, axis=2)
    return gamma


def bits_per_dim(logpz, delta_logp, image_shape, nvals: int = 256,
                 logpu: float = 0.0):
    """The training objective of ``compute_loss`` (``train_img_horo.py:
    466-501``): ``logpx = logpz - delta_logp - log(nvals)*HWC - logpu``,
    reported as bits/dim."""
    h, w, c = image_shape
    dims = h * w * c
    logpx = logpz - delta_logp - jnp.log(nvals) * dims - logpu
    return -logpx / (dims * jnp.log(2.0))
