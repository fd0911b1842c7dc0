"""Sharded stain-processing paths: data-parallel tiles + pixel sharding.

The reference streams 100k+ tiles per WSI through per-image CPU calls
(``data_utils.py:1``); the scaling axes here are (SURVEY.md section 2.5):

  * ``data``: tile batches sharded across devices/hosts — each device runs
    the identical normalization program on its shard, no communication at
    all (stain normalization is embarrassingly parallel over tiles);
  * ``pixel``: the sequence-parallel analogue — the flattened pixel axis of
    a huge solve sharded across devices (useful when a single slide-level
    solve exceeds one device's memory), again collective-free since the
    closed-form lasso is per-pixel.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from stainlib_tpu.normalization import extractive
from stainlib_tpu.ops.lasso import nonneg_lasso_k2


def normalize_batch_sharded(mesh: Mesh, target_rgb, batch_rgb,
                            method: str = "macenko", axis: str = "data"):
    """Fit on the (replicated) target, transform a 'data'-sharded tile batch.

    The 'data' axis size must divide the batch's leading axis. Returns uint8
    tiles with the same sharding as the input. Every tile's transform is
    independent of the others, so the result equals the single-device
    ``extractive.transform`` bit for bit.
    """
    params = extractive.fit(target_rgb, method=method)
    batch_sharded = jax.device_put(
        batch_rgb, NamedSharding(mesh, P(axis, None, None, None))
    )
    params = jax.device_put(params, NamedSharding(mesh, P()))

    @jax.jit
    def run(params, batch):
        return extractive.transform(params, batch, method=method)

    return run(params, batch_sharded)


def sharded_concentrations(mesh: Mesh, od_pixels, stain_matrix,
                           regularizer: float = 0.01, axis: str = "pixel"):
    """Pixel-sharded exact lasso over (N, 3) OD pixels.

    The mesh's total device count must divide ``N`` when using the default
    single-axis mesh. Collective-free: concentrations are per-pixel.
    """
    if axis not in mesh.axis_names:
        axis = mesh.axis_names[0]

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P()),
        out_specs=P(axis, None),
        check_vma=False,
    )
    def solve(od_shard, M):
        return nonneg_lasso_k2(od_shard, M, regularizer)

    return jax.jit(solve)(jnp.asarray(od_pixels, jnp.float32),
                          jnp.asarray(stain_matrix, jnp.float32))
