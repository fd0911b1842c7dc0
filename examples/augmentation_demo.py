#!/usr/bin/env python
"""End-to-end usage demo: every augmenter and normalizer on one patch.

The script counterpart of the reference's ``stainlib_augmentation.ipynb``
(cells 4-15: Grayscale, HED-lighter, Stain augmentation with macenko and
vahadane, via randomize()+transform() and fit()+pop() loops), extended with
the normalizers and the batched functional API. Saves one grid PNG.

  python examples/augmentation_demo.py --out /tmp/stain_demo.png
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


def he_patch(h=224, w=224, seed=0):
    rng = np.random.default_rng(seed)
    he = np.array([[0.55, 0.72, 0.42], [0.17, 0.80, 0.57]])
    he /= np.linalg.norm(he, axis=1, keepdims=True)
    yy, xx = np.mgrid[0:h, 0:w].astype(float)
    C = np.stack([
        np.clip(0.8 + 0.6 * np.sin(yy / 19) * np.cos(xx / 17), 0, None),
        np.clip(0.6 + 0.4 * np.cos(yy / 23) * np.sin(xx / 13), 0, None),
    ], -1) * (0.9 + 0.2 * rng.random((h, w, 2)))
    return np.clip(255 * np.exp(-(C @ he)), 0, 255).astype(np.uint8)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="/tmp/stain_demo.png")
    args = ap.parse_args()

    import stainlib_tpu as sl
    from stainlib_tpu.augmentation import functional as F
    from stainlib_tpu.augmentation.hsv import hsv_light
    from stainlib_tpu.utils.plot import plot_image_grid

    patch = he_patch(seed=1)
    target = he_patch(seed=2)
    images, titles = [patch], ["original"]

    # --- object API, exactly like the reference notebook -------------------
    aug = sl.HedLighterColorAugmenter()
    aug.randomize()
    images.append(aug.transform(patch))
    titles.append("HED lighter (randomize+transform)")

    g = sl.GrayscaleAugmentor()
    g.fit(patch)
    images.append(g.pop())
    titles.append("Grayscale (fit+pop)")

    for method in ("macenko", "vahadane"):
        s = sl.StainAugmentor(method)
        s.fit(patch)
        images.append(s.pop())
        titles.append(f"Stain augment ({method})")

        n = sl.ExtractiveStainNormalizer(method)
        n.fit(target)
        images.append(n.transform(patch))
        titles.append(f"Normalized to target ({method})")

    r = sl.ReinhardStainNormalizer()
    r.fit(target)
    images.append(r.transform(patch))
    titles.append("Reinhard")

    # --- batched functional API (the throughput surface) --------------------
    key = jax.random.PRNGKey(0)
    batch = jnp.asarray(np.stack([patch] * 4))
    images.append(np.asarray(F.hed_strong(batch, key))[0])
    titles.append("HED strong (batched)")
    images.append(np.asarray(hsv_light(batch, key))[0])
    titles.append("HSV light (batched)")
    images.append(np.asarray(F.rgb_jitter(batch, key))[0])
    titles.append("RGB jitter (batched)")

    path = plot_image_grid(images, titles, cols=4, save_path=args.out)
    print(f"wrote {path} with {len(images)} panels")


if __name__ == "__main__":
    main()
