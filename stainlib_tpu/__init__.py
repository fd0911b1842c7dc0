"""stainlib_tpu — a batched JAX histopathology stain-processing framework.

Built from scratch in JAX/XLA with the capabilities of
``sebastianffx/stainlib`` (see SURVEY.md): stain normalization (Reinhard,
Macenko, Vahadane), stain augmentation (HED jitter, grayscale,
stain-concentration perturbation), luminosity standardization and tissue
masking — all as pure, batched, jit-compiled functions — plus the deep
model families (DANN stain-invariant training; residual-flow + GMM color
normalization) on sharded JAX collectives.

Two API layers:
  * functional (``stainlib_tpu.ops`` / ``extraction`` / ``normalization`` /
    ``augmentation``): batched pure functions — the throughput surface;
  * object (``stainlib_tpu.api``, re-exported here): drop-in classes with
    the reference's names and contracts (``stainlib/__init__.py:19-30``).
"""

from stainlib_tpu.api import (
    ExtractiveStainNormalizer,
    LuminosityStandardizer,
    LuminosityThresholdTissueLocator,
    MacenkoStainExtractor,
    ReinhardStainNormalizer,
    VahadaneStainExtractor,
    get_concentrations,
)
from stainlib_tpu.augmentation import (
    GrayscaleAugmentor,
    HedColorAugmenter,
    HedColorAugmenter1,
    HedLightColorAugmenter,
    HedLighterColorAugmenter,
    HedStrongColorAugmenter,
    StainAugmentor,
)
from stainlib_tpu.exceptions import (
    DigitalPathologyAugmentationError,
    DigitalPathologyError,
    InvalidRangeError,
    TissueMaskException,
)

__version__ = "0.1.0"

__all__ = [
    "HedColorAugmenter",
    "HedColorAugmenter1",
    "HedLighterColorAugmenter",
    "HedLightColorAugmenter",
    "HedStrongColorAugmenter",
    "GrayscaleAugmentor",
    "StainAugmentor",
    "ExtractiveStainNormalizer",
    "ReinhardStainNormalizer",
    "MacenkoStainExtractor",
    "VahadaneStainExtractor",
    "LuminosityStandardizer",
    "LuminosityThresholdTissueLocator",
    "get_concentrations",
    "DigitalPathologyError",
    "DigitalPathologyAugmentationError",
    "InvalidRangeError",
    "TissueMaskException",
]
