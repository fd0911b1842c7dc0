"""Percentile and masked-statistic primitives, jit-safe with static shapes.

The reference calls ``np.percentile`` at three sites (Macenko angle bounds
``macenko_stain_extractor.py:33-35``, concentration max ``normalizer.py:36,46``,
brightness/luminosity standardization ``stain_utils.py:64,193``) and computes
masked statistics by boolean fancy-indexing (``OD[tissue_mask]``), which is a
dynamic shape. Here these become sort-based percentiles with masks folded in
as +inf sentinels, keeping every shape static.

All functions use NumPy's default 'linear' interpolation so results agree with
the CPU reference bit-for-bit in float64 and to float32 rounding on device.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Above this many elements per reduction axis, percentiles switch from an
# XLA sort (O(N log N), the dominant cost of the functional path on large
# fields — the r2 "512^2 cliff") to streaming count-bisection: ~26
# bandwidth-bound reductions resolve both interpolation ranks essentially
# exactly. 512^2 itself stays on the sort so existing golden trajectories
# are unchanged.
_BISECT_THRESHOLD = 512 * 512
# K interior candidates narrow the bracket by a factor K+1 per round: the
# counts for all candidates (and all requested q's) are SIBLING reductions
# over the same operand, which XLA fuses into one traversal — so a round
# resolving log2(K+1) bits costs about the same memory time as the old
# one-bit midpoint round, cutting the latency-bound round count 3x.
_BISECT_CANDS = 7
_BISECT_ROUNDS = 8  # 8 rounds * 3 bits = the same 2^-24 bracket as before
_BIG = 3.4e38


def _percentile_bisect(values, mask, q, n_rounds=_BISECT_ROUNDS,
                       n_cands=_BISECT_CANDS):
    """np.percentile(values[mask], q) along the last axis by multi-candidate
    count bisection: each round counts ``n_cands`` interior thresholds (one
    fused traversal) and keeps the sub-bracket containing the rank-floor
    order statistic; both interpolation ranks are then snapped EXACTLY to
    data values (max-in-bracket / min-above-bracket), so agreement with the
    sort path is limited only by f32 interpolation arithmetic. ``q`` may be
    a scalar or an (m,) vector — all q's share every traversal. O(n_rounds)
    full passes, no sort, no N log N — the bandwidth-bound form for large
    fields.
    """
    big = jnp.float32(_BIG)
    v = jnp.asarray(values, jnp.float32)
    if mask is None:
        vm = v
        n = jnp.full(v.shape[:-1], v.shape[-1], jnp.float32)
    else:
        vm = jnp.where(mask, v, big)
        n = jnp.sum(mask, axis=-1).astype(jnp.float32)
    q = jnp.asarray(q, jnp.float32)
    scalar_q = q.ndim == 0
    qv = jnp.atleast_1d(q)  # (m,)
    bshape = (1,) * (v.ndim - 1)
    rank = (qv.reshape(qv.shape + bshape) / 100.0
            * jnp.maximum(n - 1.0, 0.0))  # (m, *batch)
    rank_lo = jnp.floor(rank)
    frac = rank - rank_lo

    lo = jnp.min(jnp.where(vm < big, vm, big), axis=-1)
    hi = jnp.max(jnp.where(vm < big, vm, -big), axis=-1)
    hi = jnp.maximum(hi, lo)
    lo = jnp.broadcast_to(lo, rank.shape)
    hi = jnp.broadcast_to(hi, rank.shape)

    def body(_, state):
        lo, hi = state
        step = (hi - lo) / jnp.float32(n_cands + 1)
        new_lo, new_hi = lo, hi
        # Ascending candidates; `take` (v_(k) <= mid_j) is monotone in j,
        # so the running selects land on the tightest bracket. One count
        # per (q, candidate), all siblings over the same vm.
        for j in range(1, n_cands + 1):
            mid = lo + step * jnp.float32(j)  # (m, *batch)
            cnt = jnp.sum(vm[None] <= mid[..., None], axis=-1)
            take = cnt > rank_lo
            new_lo = jnp.where(take, new_lo, mid)
            new_hi = jnp.where(take, jnp.minimum(new_hi, mid), new_hi)
        return new_lo, new_hi

    _, hi_a = jax.lax.fori_loop(0, n_rounds, body, (lo, hi))
    # Snap rank k to the largest data value inside the bracket, and rank
    # k+1 to either the same bracket or the smallest value above it.
    v_a = jnp.max(jnp.where(vm[None] <= hi_a[..., None], vm[None], -big),
                  axis=-1)
    cnt_hi = jnp.sum(vm[None] <= hi_a[..., None], axis=-1)
    succ = jnp.min(jnp.where(vm[None] > hi_a[..., None], vm[None], big),
                   axis=-1)
    v_b = jnp.where(cnt_hi > rank_lo + 1.0, v_a, succ)
    out = v_a * (1.0 - frac) + v_b * frac
    # Empty mask: +inf, matching the sort path's sentinel propagation.
    out = jnp.where(n > 0.0, out, jnp.inf)
    return out[0] if scalar_q else out


def percentile(x, q, axis=None):
    """``np.percentile`` equivalent (linear interpolation). Large reduction
    axes route through streaming count-bisection instead of a sort; a
    sequence ``q`` stacks one bisection per entry along a leading axis
    (``jnp.percentile``'s q-leading convention)."""
    x = jnp.asarray(x, jnp.float32)
    if (axis is not None and isinstance(axis, int)
            and x.shape[axis] > _BISECT_THRESHOLD):
        xm = jnp.moveaxis(x, axis, -1)
        # Scalar and vector q alike: vector entries share every traversal.
        return _percentile_bisect(xm, None, jnp.asarray(q, jnp.float32))
    return jnp.percentile(x, q, axis=axis)


def masked_percentile(values, mask, q):
    """Percentile of ``values[mask]`` without dynamic shapes.

    ``values``: (..., N) float; ``mask``: (..., N) bool; ``q``: scalar in
    [0,100], or an (m,) vector stacked on a leading axis (large fields
    resolve all entries in shared traversals). Masked-out entries are
    sorted to the end as +inf; the linear interpolation index is computed
    against the *valid* count, matching ``np.percentile(values[mask], q)``.
    With an empty mask the result is undefined (+inf propagates); callers
    gate on the valid count. Fields larger than 512^2 use streaming
    count-bisection instead of the sort.
    """
    values = jnp.asarray(values, jnp.float32)
    if values.shape[-1] > _BISECT_THRESHOLD:
        return _percentile_bisect(values, mask, q)
    qa = jnp.asarray(q, jnp.float32)
    if qa.ndim:
        return jnp.stack([masked_percentile(values, mask, qi) for qi in qa])
    v = jnp.where(mask, values, jnp.inf)
    v = jnp.sort(v, axis=-1)
    n = jnp.sum(mask, axis=-1).astype(jnp.float32)
    rank = jnp.asarray(q, jnp.float32) / 100.0 * jnp.maximum(n - 1.0, 0.0)
    lo = jnp.floor(rank).astype(jnp.int32)
    hi = jnp.ceil(rank).astype(jnp.int32)
    frac = rank - lo.astype(jnp.float32)
    v_lo = jnp.take_along_axis(v, lo[..., None], axis=-1)[..., 0]
    v_hi = jnp.take_along_axis(v, hi[..., None], axis=-1)[..., 0]
    return v_lo * (1.0 - frac) + v_hi * frac


def masked_mean(values, mask, axis=None):
    """Mean over masked entries; 0-safe (returns 0 for an empty mask)."""
    m = jnp.asarray(mask, jnp.float32)
    v = jnp.asarray(values, jnp.float32)
    n = jnp.sum(m, axis=axis)
    return jnp.sum(v * m, axis=axis) / jnp.maximum(n, 1.0)


def mean_std(values, axis=None):
    """Population mean/std, matching ``cv.meanStdDev`` (``stain_utils.py:181``)
    which divides by N (not N-1)."""
    v = jnp.asarray(values, jnp.float32)
    mu = jnp.mean(v, axis=axis)
    sd = jnp.sqrt(jnp.maximum(jnp.mean(v * v, axis=axis) - mu * mu, 0.0))
    return mu, sd
