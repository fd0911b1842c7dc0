"""Perceptual color difference (delta-E) — the fidelity metric.

The fidelity contract bounds output error as "mean delta-E < 1.0 vs the CPU
reference"; this is the public, batched harness for it (SURVEY.md section 7
step 10): CIE76 (Euclidean CIELAB distance) on our OpenCV-parity LAB
transform, plus the mean/percentile reductions the fidelity tests use.
"""

from __future__ import annotations

import jax.numpy as jnp

from stainlib_tpu.ops.colorspace import rgb_to_lab


def delta_e76(rgb_a, rgb_b):
    """Per-pixel CIE76 delta-E between two RGB [0,255] images/batches."""
    la = rgb_to_lab(rgb_a)
    lb = rgb_to_lab(rgb_b)
    return jnp.sqrt(jnp.sum((la - lb) ** 2, axis=-1))


def mean_delta_e(rgb_a, rgb_b):
    """Mean delta-E over all pixels (the ΔE<1.0 acceptance statistic)."""
    return jnp.mean(delta_e76(rgb_a, rgb_b))


def delta_e_report(rgb_a, rgb_b):
    """(mean, p95, max) delta-E — the triple the fidelity harness logs."""
    de = delta_e76(rgb_a, rgb_b).reshape(-1)
    return (jnp.mean(de), jnp.percentile(de, 95.0), jnp.max(de))
