"""Batched geometric augmentation: homography-composed affine warps.

Batched JAX re-design of the DANN pipeline's Keras-style geometric
augmentation (``dlmodels/stain_adversarial_learning/utils/keras_utils.py:
40-158``): per-sample rotation / shift / shear / zoom composed as one
center-offset affine homography, applied with bilinear sampling (nearest
fill), plus per-channel intensity shift and random flips. The reference
warps one numpy image at a time on the host; here the whole batch is one
vmapped ``map_coordinates`` gather under jit, keyed by ``jax.random``.

Also provides the crop helpers (``keras_utils.py:21-37``) and the
flip/rot90 per-sample ops used by the balanced patch generators
(``utils_patches.py:95-118``).
"""

from __future__ import annotations

import functools


import jax
import jax.numpy as jnp


def _affine_params(key, h, w, rotation_range, width_shift_range,
                   height_shift_range, shear_range, zoom_range):
    """Draw per-sample homography parameters (keras_utils.py:85-140)."""
    ks = jax.random.split(key, 5)
    theta = jnp.deg2rad(
        jax.random.uniform(ks[0], (), minval=-rotation_range,
                           maxval=rotation_range)
    )
    tx = jax.random.uniform(ks[1], (), minval=-height_shift_range,
                            maxval=height_shift_range) * h
    ty = jax.random.uniform(ks[2], (), minval=-width_shift_range,
                            maxval=width_shift_range) * w
    shear = jnp.deg2rad(
        jax.random.uniform(ks[3], (), minval=-shear_range, maxval=shear_range)
    )
    zx, zy = jax.random.uniform(
        ks[4], (2,), minval=1.0 - zoom_range, maxval=1.0 + zoom_range
    )

    cos_t, sin_t = jnp.cos(theta), jnp.sin(theta)
    rotation = jnp.array([[cos_t, -sin_t, 0.0], [sin_t, cos_t, 0.0],
                          [0.0, 0.0, 1.0]])
    shift = jnp.array([[1.0, 0.0, 1.0], [0.0, 1.0, 1.0], [0.0, 0.0, 1.0]])
    shift = shift.at[0, 2].set(tx).at[1, 2].set(ty)
    shear_m = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    shear_m = shear_m.at[0, 1].set(-jnp.sin(shear)).at[1, 1].set(jnp.cos(shear))
    zoom = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[0, 0].set(zx).at[1, 1].set(zy)
    # Full-precision 3x3 products: a TF32 product on a GPU would shift the
    # sampling grid by up to ~1e-3 of the image size.
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    m = mm(mm(mm(rotation, shift), shear_m), zoom)

    # Offset so the transform is about the image center
    # (image.transform_matrix_offset_center).
    ox, oy = h / 2.0 - 0.5, w / 2.0 - 0.5
    offset = jnp.array([[1.0, 0.0, ox], [0.0, 1.0, oy], [0.0, 0.0, 1.0]])
    reset = jnp.array([[1.0, 0.0, -ox], [0.0, 1.0, -oy], [0.0, 0.0, 1.0]])
    return mm(mm(offset, m), reset)


def _warp_one(img, matrix):
    """Affine-warp one (H, W, C) image: output(r) = input(M @ r), bilinear,
    nearest-edge fill (fill_mode='nearest')."""
    h, w, _ = img.shape
    rr = jnp.arange(h, dtype=jnp.float32)
    cc = jnp.arange(w, dtype=jnp.float32)
    R, C = jnp.meshgrid(rr, cc, indexing="ij")
    src_r = matrix[0, 0] * R + matrix[0, 1] * C + matrix[0, 2]
    src_c = matrix[1, 0] * R + matrix[1, 1] * C + matrix[1, 2]
    coords = jnp.stack([src_r, src_c])

    def sample_channel(ch):
        return jax.scipy.ndimage.map_coordinates(
            ch, [coords[0], coords[1]], order=1, mode="nearest"
        )

    return jnp.stack(
        [sample_channel(img[..., c]) for c in range(img.shape[-1])], axis=-1
    )


@functools.partial(
    jax.jit,
    static_argnames=("rotation_range", "width_shift_range",
                     "height_shift_range", "shear_range", "zoom_range",
                     "channel_shift_range", "horizontal_flip",
                     "vertical_flip"),
)
def random_geometric(
    rgb,
    key,
    rotation_range: float = 0.0,
    width_shift_range: float = 0.0,
    height_shift_range: float = 0.0,
    shear_range: float = 0.0,
    zoom_range: float = 0.0,
    channel_shift_range: float = 0.0,
    horizontal_flip: bool = False,
    vertical_flip: bool = False,
):
    """Per-sample random affine + channel shift + flips over (B, H, W, C).

    Float in, float out (same value range as the input; the reference works
    on float32 patches).
    """
    x = jnp.asarray(rgb, jnp.float32)
    B, h, w, _ = x.shape
    keys = jax.random.split(key, B)

    def one(img, k):
        k_aff, k_ch, k_hf, k_vf = jax.random.split(k, 4)
        m = _affine_params(k_aff, h, w, rotation_range, width_shift_range,
                           height_shift_range, shear_range, zoom_range)
        out = _warp_one(img, m)
        if channel_shift_range:
            shift = jax.random.uniform(
                k_ch, (3,), minval=-channel_shift_range,
                maxval=channel_shift_range,
            )
            out = out + shift
        if horizontal_flip:
            out = jnp.where(jax.random.bernoulli(k_hf), out[:, ::-1], out)
        if vertical_flip:
            out = jnp.where(jax.random.bernoulli(k_vf), out[::-1], out)
        return out

    return jax.vmap(one)(x, keys)


def random_flips_rots(rgb, key):
    """Random member of the dihedral group D4 per sample: the flips + 90-deg
    rotations the balanced generators apply (``utils_patches.py:95-118``)."""
    x = jnp.asarray(rgb)
    B = x.shape[0]
    codes = jax.random.randint(key, (B,), 0, 8)

    def one(img, code):
        k = code % 4
        rot = jax.lax.switch(
            k,
            [lambda i: i, lambda i: jnp.rot90(i, 1), lambda i: jnp.rot90(i, 2),
             lambda i: jnp.rot90(i, 3)],
            img,
        )
        return jnp.where(code >= 4, rot[:, ::-1], rot)

    return jax.vmap(one)(x, codes)


def center_crop(rgb, target: int):
    """Center crop to (target, target) (``center_cropping``,
    ``utils_patches.py:21-30``)."""
    h, w = rgb.shape[-3], rgb.shape[-2]
    r0 = h // 2 - target // 2
    c0 = w // 2 - target // 2
    return rgb[..., r0 : r0 + target, c0 : c0 + target, :]


def random_crop(rgb, key, target: int):
    """Random crop per sample to (target, target) (``random_crop``,
    ``keras_utils.py:21-30``)."""
    x = jnp.asarray(rgb)
    B, h, w, c = x.shape
    k1, k2 = jax.random.split(key)
    r0 = jax.random.randint(k1, (B,), 0, h - target + 1)
    c0 = jax.random.randint(k2, (B,), 0, w - target + 1)

    def one(img, r, c_):
        return jax.lax.dynamic_slice(img, (r, c_, 0), (target, target, c))

    return jax.vmap(one)(x, r0, c0)
