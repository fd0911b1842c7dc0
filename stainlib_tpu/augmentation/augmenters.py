"""Drop-in augmenter classes mirroring ``stainlib/augmentation/augmenter.py``.

Same names, constructor signatures, validation errors and
``randomize()/transform()`` (or ``fit()/pop()``) contracts as the reference
(``augmenter.py:19-448``); execution is delegated to the batched functional
kernels in :mod:`stainlib_tpu.augmentation.functional`. Statefulness is
confined to an explicit ``jax.random`` key chain per object — no global RNG.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from stainlib_tpu.augmentation import functional as F
from stainlib_tpu.exceptions import InvalidRangeError, TissueMaskException
from stainlib_tpu.ops.tissue import tissue_mask


def _validate_range(title, rng, lo=-1.0, hi=1.0):
    """Range validation of ``augmenter.py:160-274``."""
    if rng is None:
        return
    if len(rng) != 2 or rng[1] < rng[0] or rng[0] < lo or hi < rng[1]:
        raise InvalidRangeError(title, rng)


class AugmenterBase:
    """Base class for patch augmentation (``augmenter.py:19-70``)."""

    def __init__(self, keyword: str, seed: int = 0):
        self._keyword = keyword
        self._key = jax.random.PRNGKey(seed)

    @property
    def keyword(self):
        return self._keyword

    def shapes(self, target_shapes):
        """Output shapes match input shapes by default (``augmenter.py:44-57``)."""
        return target_shapes

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def transform(self, patch):
        raise NotImplementedError

    def randomize(self):
        pass


class ColorAugmenterBase(AugmenterBase):
    """Base class for color patch augmentation (``augmenter.py:72-84``)."""


class HedColorAugmenter(ColorAugmenterBase):
    """HED sigma/bias jitter (``augmenter.py:86-344``).

    ``randomize()`` draws fresh sigmas/biases; ``transform(patch)`` applies
    the current ones with the patch-mean cutoff gate. Accepts single HWC
    patches (uint8 or float [0,1], like the reference) or batches.
    """

    def __init__(self, haematoxylin_sigma_range, haematoxylin_bias_range,
                 eosin_sigma_range, eosin_bias_range, dab_sigma_range,
                 dab_bias_range, cutoff_range, seed: int = 0):
        super().__init__(keyword="hed_color", seed=seed)
        for title, rng in [
            ("Haematoxylin Sigma", haematoxylin_sigma_range),
            ("Eosin Sigma", eosin_sigma_range),
            ("Dab Sigma", dab_sigma_range),
            ("Haematoxylin Bias", haematoxylin_bias_range),
            ("Eosin Bias", eosin_bias_range),
            ("Dab Bias", dab_bias_range),
        ]:
            _validate_range(title, rng)
        _validate_range("Cutoff", cutoff_range, lo=0.0, hi=1.0)

        self._sigma_ranges = [haematoxylin_sigma_range, eosin_sigma_range,
                              dab_sigma_range]
        self._bias_ranges = [haematoxylin_bias_range, eosin_bias_range,
                             dab_bias_range]
        self._cutoff_range = cutoff_range if cutoff_range is not None else (0.0, 1.0)
        # Initial parameters: range lower bounds (augmenter.py:196-201,255-259).
        self._sigmas = [r[0] if r is not None else 0.0 for r in self._sigma_ranges]
        self._biases = [r[0] if r is not None else 0.0 for r in self._bias_ranges]

    def randomize(self):
        k_s, k_b = jax.random.split(self._next_key())
        u_s = jax.random.uniform(k_s, (3,))
        u_b = jax.random.uniform(k_b, (3,))
        # A None sigma range randomizes to 1.0 (not 0.0) in the reference
        # (augmenter.py:338-340); None bias randomizes to 0.0.
        self._sigmas = [
            float(r[0] + u * (r[1] - r[0])) if r is not None else 1.0
            for r, u in zip(self._sigma_ranges, np.asarray(u_s))
        ]
        self._biases = [
            float(r[0] + u * (r[1] - r[0])) if r is not None else 0.0
            for r, u in zip(self._bias_ranges, np.asarray(u_b))
        ]

    def transform(self, patch):
        patch = np.asarray(patch)
        is_float = patch.dtype.kind == "f"
        x = patch * 255.0 if is_float else patch
        lead = x.shape[:-3]
        sig = jnp.broadcast_to(jnp.asarray(self._sigmas, jnp.float32), lead + (3,))
        bia = jnp.broadcast_to(jnp.asarray(self._biases, jnp.float32), lead + (3,))
        out = F.hed_jitter_apply(jnp.asarray(x), sig, bia, tuple(self._cutoff_range))
        out = np.asarray(out)
        return out.astype(np.float64) / 255.0 if is_float else out


class HedColorAugmenter1(HedColorAugmenter):
    """Symmetric-threshold preset (``augmenter.py:346-360``)."""

    def __init__(self, thresh, seed: int = 0):
        r = (-thresh, thresh)
        super().__init__(r, r, r, r, r, r, cutoff_range=(0.05, 0.95), seed=seed)


class HedLighterColorAugmenter(HedColorAugmenter1):
    def __init__(self, seed: int = 0):
        super().__init__(0.03, seed=seed)


class HedLightColorAugmenter(HedColorAugmenter1):
    def __init__(self, seed: int = 0):
        super().__init__(0.1, seed=seed)


class HedStrongColorAugmenter(HedColorAugmenter1):
    def __init__(self, seed: int = 0):
        super().__init__(1.0, seed=seed)


class GrayscaleAugmentor:
    """fit/pop grayscale jitter (``augmenter.py:374-401``)."""

    def __init__(self, sigma1=0.2, sigma2=0.2, augment_background=False,
                 seed: int = 0):
        self.sigma1 = sigma1
        self.sigma2 = sigma2
        self.augment_background = augment_background
        self._key = jax.random.PRNGKey(seed)
        self.image = None

    def fit(self, I):
        self.image_shape = I.shape
        tm = tissue_mask(jnp.asarray(I))
        if int(tm.count) == 0:
            raise TissueMaskException("Empty tissue mask computed")
        self.tissue_mask = np.asarray(tm.mask).ravel()
        self.image = jnp.asarray(I)

    def pop(self):
        self._key, k = jax.random.split(self._key)
        return np.asarray(F.grayscale_augment(self.image, k))


class StainAugmentor:
    """fit/pop stain-concentration perturbation (``augmenter.py:403-448``)."""

    def __init__(self, method, sigma1=0.2, sigma2=0.2,
                 augment_background=False, seed: int = 0):
        if method.lower() not in ("macenko", "vahadane"):
            raise Exception("Method not recognized.")
        self.method = method.lower()
        self.sigma1 = sigma1
        self.sigma2 = sigma2
        self.augment_background = augment_background
        self._key = jax.random.PRNGKey(seed)
        self._params = None

    def fit(self, I):
        self.image_shape = I.shape
        self._params = jax.tree.map(
            jax.block_until_ready,
            F.stain_augment_fit(jnp.asarray(I), method=self.method),
        )
        if bool(jnp.isnan(self._params.stain_matrix).any()):
            raise TissueMaskException("Empty tissue mask computed")
        self.stain_matrix = np.asarray(self._params.stain_matrix)
        self.source_concentrations = np.asarray(
            self._params.concentrations
        ).reshape(-1, 2)
        self.n_stains = 2
        self.tissue_mask = np.asarray(self._params.mask).ravel()

    def pop(self):
        if self._params is None:
            raise RuntimeError("Call fit(I) before pop().")
        self._key, k = jax.random.split(self._key)
        out = F.stain_augment_pop(
            self._params, k, self.sigma1, self.sigma2,
            self.augment_background,
        )
        return np.asarray(out)
