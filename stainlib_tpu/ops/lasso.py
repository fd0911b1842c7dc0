"""Non-negative lasso concentration solvers.

The reference solves, per pixel x (OD, 3-vector), the SPAMS problem
``spams.lasso(X, D, mode=2, lambda1, pos=True)`` —

    min_{c >= 0}  0.5 * ||x - D c||^2 + lambda * ||c||_1

with D = stain_matrix.T (3 x 2) — at ``stainlib/utils/stain_utils.py:69-78``,
via the native C++ LARS solver. For K = 2 stains this QP has a tiny exact
closed form: enumerate the 2^2 active sets and pick the (unique, since
G = D^T D is PD for non-parallel stains) KKT-satisfying candidate. That makes
the hot per-pixel solve a handful of fused elementwise ops — exact (it is the same
global optimum LARS finds), branch-free, bitwise deterministic, and trivially
batched over all pixels of all tiles, instead of an iterative native solver.

A fixed-iteration projected FISTA is provided for general K and as an
independent numerical cross-check.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST


def nonneg_lasso_k2(od, stain_matrix, regularizer: float = 0.01):
    """Exact concentrations for the 2-stain model, all pixels at once.

    Args:
      od: (..., 3) optical densities.
      stain_matrix: (..., 2, 3) row-normalized stain OD vectors; leading axes
        broadcast against ``od``'s batch axes.
      regularizer: the L1 weight (``lambda1``; reference default 0.01 at
        ``stain_utils.py:69``).

    Returns:
      (..., 2) non-negative concentrations: the exact minimizer of
      ``0.5*||od - c @ M||^2 + regularizer*||c||_1`` over ``c >= 0``.
    """
    od = jnp.asarray(od, jnp.float32)
    M = jnp.asarray(stain_matrix, jnp.float32)
    # Gram matrix of the two stain vectors: G = M M^T (2x2, symmetric PD).
    g11 = jnp.sum(M[..., 0, :] * M[..., 0, :], axis=-1)
    g22 = jnp.sum(M[..., 1, :] * M[..., 1, :], axis=-1)
    g12 = jnp.sum(M[..., 0, :] * M[..., 1, :], axis=-1)
    det = jnp.maximum(g11 * g22 - g12 * g12, 1e-12)

    # b = M . od - lambda, per pixel.
    b1 = jnp.einsum("...c,...c->...", od, M[..., 0, :], precision=_HI) - regularizer
    b2 = jnp.einsum("...c,...c->...", od, M[..., 1, :], precision=_HI) - regularizer

    # Candidate: both stains active -> c = G^{-1} b.
    c1_full = (g22 * b1 - g12 * b2) / det
    c2_full = (g11 * b2 - g12 * b1) / det
    ok_full = (c1_full >= 0.0) & (c2_full >= 0.0)

    # Candidate: only stain 1 active. KKT for the zero coordinate:
    # grad_2 = g12*c1 - b2 >= 0.
    c1_only = jnp.maximum(b1, 0.0) / jnp.maximum(g11, 1e-12)
    ok_1 = (b1 >= 0.0) & (g12 * c1_only - b2 >= 0.0)

    # Candidate: only stain 2 active.
    c2_only = jnp.maximum(b2, 0.0) / jnp.maximum(g22, 1e-12)
    ok_2 = (b2 >= 0.0) & (g12 * c2_only - b1 >= 0.0)

    # Priority: interior, then single-active, then zero. Exactly one candidate
    # is KKT-valid up to boundary ties, where the candidates coincide.
    c1 = jnp.where(ok_full, c1_full, jnp.where(ok_1, c1_only, 0.0))
    c2 = jnp.where(ok_full, c2_full, jnp.where(~ok_1 & ok_2, c2_only, 0.0))
    return jnp.stack([c1, c2], axis=-1)


def get_concentrations(rgb, stain_matrix, regularizer: float = 0.01):
    """RGB [0,255] (..., H, W, 3) -> concentrations (..., H, W, 2).

    Batched, fused equivalent of ``get_concentrations`` (``stain_utils.py:
    69-78``): OD conversion over *all* pixels (no tissue mask — the reference
    solves every pixel) followed by the exact non-negative lasso.
    """
    from stainlib_tpu.ops.colorspace import rgb_to_od

    od = rgb_to_od(rgb)
    if stain_matrix.ndim > 2:
        # Per-image stain matrices: align (..., 2, 3) against (..., H, W, 3).
        stain_matrix = stain_matrix[..., None, None, :, :]
    return nonneg_lasso_k2(od, stain_matrix, regularizer)


def nonneg_lasso_fista(X, D, regularizer: float, num_iters: int = 200):
    """Projected FISTA for ``min_{A>=0} 0.5||X - A D||^2 + reg*||A||_1``.

    General-K fallback and cross-check for :func:`nonneg_lasso_k2`.
    ``X``: (N, P) observations; ``D``: (K, P) dictionary rows. Returns (N, K).
    Fixed iteration count -> jit-stable shapes and deterministic output.
    """
    X = jnp.asarray(X, jnp.float32)
    D = jnp.asarray(D, jnp.float32)
    G = jnp.matmul(D, D.T, precision=_HI)  # (K, K)
    B = jnp.matmul(X, D.T, precision=_HI)  # (N, K)
    # Lipschitz constant of the quadratic: largest eigenvalue of G, bounded by
    # its trace (cheap, jit-friendly, and tight enough at K=2).
    L = jnp.trace(G) + 1e-6
    step = 1.0 / L

    def body(carry, _):
        A, Y, t = carry
        grad = jnp.matmul(Y, G, precision=_HI) - B
        A_next = jnp.maximum(Y - step * (grad + regularizer), 0.0)
        t_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * t * t))
        Y_next = A_next + ((t - 1.0) / t_next) * (A_next - A)
        return (A_next, Y_next, t_next), None

    A0 = jnp.zeros_like(B)
    (A, _, _), _ = jax.lax.scan(body, (A0, A0, jnp.float32(1.0)), None, length=num_iters)
    return A
