"""Host-side (numpy) crappifiers (counterpart: pssr2_tpu/crappifiers.py:
16-128; reference: pssr/crappifiers.py).  They draw from numpy's global
stream, as the JAX package's do, so seeding ``np.random`` seeds both.

Images are float arrays of uint8-range values [0, 255], channel-first.
Crappifiers only inject noise; the downscale happens upstream.  A
crappifier's device form, for the training pipeline, is
``ops/degrade.to_device_fn``.
"""

from abc import ABC, abstractmethod

import numpy as np


class Crappifier(ABC):
    """Base class for custom crappifiers. Override :meth:`crappify`."""

    @abstractmethod
    def crappify(self, image: np.ndarray):
        """Inject noise into a low-resolution image (no downscaling)."""
        raise NotImplementedError('"crappify" method not implemented.')

    def __call__(self, image: np.ndarray):
        return self.crappify(image)


class _SpreadMixin:
    """Per-call intensity jitter (reference: pssr/crappifiers.py:63, 85)."""

    def _draw_intensity(self) -> float:
        if self.spread > 0:
            return max(np.random.normal(self.intensity, self.spread), 0)
        return self.intensity


class Poisson(Crappifier, _SpreadMixin):
    def __init__(self, intensity: float = 1, gain: float = 0, spread: float = 0):
        """Poisson (shot) noise: interpolates the image toward a Poisson
        sample of itself.

        Args:
            intensity (float) : Mix of the Poisson sample. 1 is the standard
                distribution, 0 is none, >1 amplifies noise. Default 1.

            gain (float) : Value gain added to the output. Default 0.

            spread (float) : Std-dev of per-call intensity jitter. Default 0.
        """
        self.intensity = intensity
        self.gain = gain
        self.spread = spread

    def crappify(self, image: np.ndarray):
        sample = np.random.poisson(np.clip(image, 0, np.inf))
        intensity = self._draw_intensity()
        x = image.astype(np.float32)
        return x * (1 - intensity) + sample * intensity + self.gain
