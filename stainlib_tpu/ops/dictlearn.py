"""Sparse non-negative dictionary learning for Vahadane stain estimation.

Replaces ``spams.trainDL(X=OD.T, K=2, lambda1, mode=2, modeD=0, posAlpha=True,
posD=True)`` (``stainlib/extraction/vahadane_stain_extractor.py:35-36``) —
the native C++/OpenMP online dictionary learner — with a fixed-iteration
batch alternating minimization that is jit-compiled end to end:

  * sparse-code step: the *exact* closed-form non-negative lasso
    (:func:`stainlib_tpu.ops.lasso.nonneg_lasso_k2`) over all tissue pixels
    simultaneously — no LARS, no iteration;
  * dictionary step: Mairal-style block coordinate descent on the two stain
    vectors with the same constraint set as SPAMS (non-negative entries,
    unit L2 ball), derived from the masked sufficient statistics
    ``C = A^T W A`` and ``B = A^T W X`` so the tissue mask enters as weights
    rather than a dynamic gather.

Deterministic initialization (Ruifrok-Johnston H&E vectors) + a fixed
iteration count give bitwise-stable stain matrices across runs. SPAMS' online algorithm converges to a local optimum of the same
objective; end-to-end fidelity is validated as delta-E on reconstructed
images, not bitwise dictionary equality (SURVEY.md section 7 'hard parts').
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

_HI = lax.Precision.HIGHEST
import numpy as np

from stainlib_tpu.ops.lasso import nonneg_lasso_k2

# Ruifrok-Johnston H & E optical-density directions (row-normalized) — the
# standard published prior, used only as a deterministic starting point.
_HE_INIT = np.array(
    [[0.65, 0.70, 0.29], [0.07, 0.99, 0.11]], dtype=np.float32
)
_HE_INIT /= np.linalg.norm(_HE_INIT, axis=1, keepdims=True)


def fit_stain_dictionary(
    od,
    mask,
    regularizer: float = 0.1,
    num_iters: int = 30,
    init=None,
):
    """Learn the 2x3 stain dictionary from masked OD pixels.

    Args:
      od: (..., N, 3) optical densities (flattened pixels).
      mask: (..., N) boolean tissue mask (weights; excluded pixels contribute
        nothing, exactly like the reference's ``OD[tissue_mask]`` gather at
        ``vahadane_stain_extractor.py:30-32`` but with static shapes).
      regularizer: L1 weight on the codes (reference default 0.1).
      num_iters: fixed outer alternations.
      init: optional (..., 2, 3) initial stain matrix (e.g. a Macenko
        estimate); defaults to the Ruifrok-Johnston prior.

    Returns:
      (..., 2, 3) stain matrix, rows unit-ball-projected and non-negative.
      H/E row ordering and final row normalization are applied by the caller
      (the extractor), mirroring the reference split of responsibilities.
    """
    od = jnp.asarray(od, jnp.float32)
    w = jnp.asarray(mask, jnp.float32)
    if init is None:
        D0 = jnp.broadcast_to(jnp.asarray(_HE_INIT), od.shape[:-2] + (2, 3))
    else:
        D0 = jnp.asarray(init, jnp.float32)

    def step(D, _):
        # Sparse codes for every pixel under the current dictionary (exact).
        A = nonneg_lasso_k2(od, D[..., None, :, :], regularizer)  # (..., N, 2)
        Aw = A * w[..., None]
        C = jnp.einsum("...nk,...nl->...kl", Aw, A, precision=_HI)  # (..., 2, 2)
        B = jnp.einsum("...nk,...nc->...kc", Aw, od, precision=_HI)  # (..., 2, 3)

        # Block coordinate descent over the two stain rows, two sweeps.
        def update_row(D, j):
            cjj = jnp.maximum(C[..., j, j], 1e-8)
            resid = B[..., j, :] - jnp.einsum("...k,...kc->...c", C[..., j, :], D, precision=_HI)
            u = D[..., j, :] + resid / cjj[..., None]
            u = jnp.maximum(u, 0.0)  # posD
            norm = jnp.linalg.norm(u, axis=-1, keepdims=True)
            u = u / jnp.maximum(norm, 1.0)  # project into the unit L2 ball
            # Guard against a collapsed (all-zero) stain: keep the old row.
            dead = jnp.sum(u, axis=-1, keepdims=True) <= 0.0
            u = jnp.where(dead, D[..., j, :], u)
            return D.at[..., j, :].set(u)

        for _sweep in range(2):
            for j in range(2):
                D = update_row(D, j)
        return D, None

    D, _ = jax.lax.scan(step, D0, None, length=num_iters)
    return D
