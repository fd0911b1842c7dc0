"""HSV color jitter, PRNG-keyed and batched.

The reference's augmentation study pairs "HED-light/strong + HSV jitter" as
the in-training-loop augmentation batch; the HSV family (hue rotation,
saturation/value scaling — the 'HSV-light/strong' augmenters of Tellez et
al. 2019, the paper stainlib credits at ``stainlib/__init__.py:7-8``)
complements the grayscale augmenter (``augmenter.py:374-401``). Pure jnp
RGB<->HSV implemented inline (no OpenCV), vmap/jit-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stainlib_tpu.ops.colorspace import to_uint8


def rgb_to_hsv(rgb01):
    """RGB [0,1] -> (h in [0,1), s, v)."""
    r, g, b = rgb01[..., 0], rgb01[..., 1], rgb01[..., 2]
    mx = jnp.maximum(jnp.maximum(r, g), b)
    mn = jnp.minimum(jnp.minimum(r, g), b)
    delta = mx - mn
    safe = jnp.where(delta > 0, delta, 1.0)
    h = jnp.where(
        mx == r, (g - b) / safe,
        jnp.where(mx == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe),
    )
    h = jnp.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    s = jnp.where(mx > 0, delta / jnp.maximum(mx, 1e-12), 0.0)
    return jnp.stack([h, s, mx], axis=-1)


def hsv_to_rgb(hsv):
    """(h in [0,1), s, v) -> RGB [0,1]."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = jnp.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(jnp.int32) % 6
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [v, q, p, p, t, v])
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [t, v, v, q, p, p])
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
                   [p, p, t, v, v, q])
    return jnp.stack([r, g, b], axis=-1)


def hsv_jitter(rgb, key, hue_shift: float = 0.05, sat_range: float = 0.1,
               val_range: float = 0.1):
    """Per-image hue shift ~U(±hue_shift), saturation and value scales
    ~U(1±range). (..., H, W, 3) RGB [0,255] in -> uint8 out."""
    x = jnp.asarray(rgb, jnp.float32) / 255.0
    lead = jnp.shape(rgb)[:-3]
    k_h, k_s, k_v = jax.random.split(key, 3)
    dh = jax.random.uniform(k_h, lead, jnp.float32, -hue_shift, hue_shift)
    ds = jax.random.uniform(k_s, lead, jnp.float32, 1 - sat_range, 1 + sat_range)
    dv = jax.random.uniform(k_v, lead, jnp.float32, 1 - val_range, 1 + val_range)
    hsv = rgb_to_hsv(x)
    h = (hsv[..., 0] + dh[..., None, None]) % 1.0
    s = jnp.clip(hsv[..., 1] * ds[..., None, None], 0.0, 1.0)
    v = jnp.clip(hsv[..., 2] * dv[..., None, None], 0.0, 1.0)
    out = hsv_to_rgb(jnp.stack([h, s, v], axis=-1))
    return to_uint8(out * 255.0)


def hsv_light(rgb, key):
    """Light preset (Tellez et al. 'HSV-light')."""
    return hsv_jitter(rgb, key, 0.05, 0.1, 0.1)


def hsv_strong(rgb, key):
    """Strong preset ('HSV-strong'): full hue rotation."""
    return hsv_jitter(rgb, key, 0.5, 0.5, 0.35)
