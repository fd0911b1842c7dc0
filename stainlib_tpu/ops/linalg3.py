"""Closed-form symmetric 3x3 eigendecomposition, batched and branch-free.

Replaces ``np.linalg.eigh`` on the 3x3 OD covariance in the Macenko extractor
(``stainlib/extraction/macenko_stain_extractor.py:22``). A direct trigonometric
solve (Smith 1961) + cross-product eigenvectors is exact for this fixed tiny
size, vmaps trivially over tile batches, avoids the general eigensolver's
iteration, and is deterministic — a requirement for bitwise-stable stain
matrices from run to run.
"""

from __future__ import annotations

import jax.numpy as jnp


def eigh3x3(A, eps: float = 1e-12):
    """Eigenvalues (ascending) and eigenvectors of symmetric ``(..., 3, 3)``.

    Returns ``(w, V)`` with ``w`` shaped (..., 3) ascending and ``V`` shaped
    (..., 3, 3) whose columns are the corresponding unit eigenvectors —
    ``np.linalg.eigh``'s convention, so Macenko's ``V[:, [2, 1]]`` top-2
    selection (``macenko_stain_extractor.py:24``) carries over unchanged.
    Column signs are fixed deterministically (largest-|.| component positive).
    """
    A = jnp.asarray(A, jnp.float32)
    # Scale-normalize for numerical range, then shift by the mean eigenvalue.
    scale = jnp.maximum(jnp.max(jnp.abs(A), axis=(-2, -1), keepdims=True), eps)
    As = A / scale
    q = jnp.trace(As, axis1=-2, axis2=-1) / 3.0
    B = As - q[..., None, None] * jnp.eye(3, dtype=As.dtype)
    p2 = jnp.sum(B * B, axis=(-2, -1)) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, eps * eps))
    detB = jnp.linalg.det(B / p[..., None, None])
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # Eigenvalues of the normalized matrix, ascending.
    w2 = q + 2.0 * p * jnp.cos(phi)  # largest
    w0 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)  # smallest
    w1 = 3.0 * q - w0 - w2
    w = jnp.stack([w0, w1, w2], axis=-1)

    V = jnp.stack(
        [_eigvec(As, w[..., k], eps) for k in range(3)], axis=-1
    )  # (..., 3, 3) columns
    return w * scale[..., 0, 0][..., None], V


def _eigvec(A, lam, eps):
    """Unit eigenvector of (..., 3, 3) A for eigenvalue lam via the largest
    cross product of columns of (A - lam I); branch-free and sign-fixed."""
    M = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    c0, c1, c2 = M[..., :, 0], M[..., :, 1], M[..., :, 2]
    x01 = jnp.cross(c0, c1)
    x02 = jnp.cross(c0, c2)
    x12 = jnp.cross(c1, c2)
    n01 = jnp.sum(x01 * x01, axis=-1)
    n02 = jnp.sum(x02 * x02, axis=-1)
    n12 = jnp.sum(x12 * x12, axis=-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (~best12) & (n02 >= n01)
    v = jnp.where(
        best12[..., None], x12, jnp.where(best02[..., None], x02, x01)
    )
    # Degenerate fallback (repeated eigenvalue): any unit vector in the
    # nullspace works; pick e0 deterministically.
    nv = jnp.linalg.norm(v, axis=-1, keepdims=True)
    e0 = jnp.zeros_like(v).at[..., 0].set(1.0)
    v = jnp.where(nv > eps, v / jnp.maximum(nv, eps), e0)
    # Deterministic sign: component with the largest |.| is made positive.
    idx = jnp.argmax(jnp.abs(v), axis=-1, keepdims=True)
    lead = jnp.take_along_axis(v, idx, axis=-1)[..., 0]
    return v * jnp.where(lead < 0, -1.0, 1.0)[..., None]
