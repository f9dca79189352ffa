"""On-device crappification (counterpart: pssr2_tpu/ops/degrade.py:29-50,
93-130): a crappifier lowers to a ``(generator, images) -> images``
function over a batch, drawn from an explicit ``torch.Generator`` on the
images' device.  The JAX package draws from ``jax.random`` keys; the two
streams differ, so the draws agree in distribution, not value.

Only ``Poisson`` is ported; the other noises come with their crappifiers.
"""

from functools import partial

import torch

from ..crappifiers import Poisson


def _draw_intensity(generator, intensity: float, spread: float, n: int, device):
    """Per-sample intensity jitter, (n,) f32: max(N(intensity, spread), 0)."""
    if spread <= 0:
        return torch.full((n,), float(intensity), device=device)
    z = torch.randn(n, generator=generator, device=device)
    return torch.clamp(intensity + spread * z, min=0.0)


def poisson(generator, images, intensity: float = 1.0, gain: float = 0.0, spread: float = 0.0):
    """Mix each image of the batch toward a Poisson sample of itself:
    ``x (1 - mix) + Poisson(max(x, 0)) mix + gain``, one ``mix`` per image."""
    b = images.shape[0]
    mix = _draw_intensity(generator, intensity, spread, b, images.device)
    mix = mix.view(b, *([1] * (images.dim() - 1)))
    x = images.float()
    sample = torch.poisson(torch.clamp(x, min=0.0), generator=generator)
    return x * (1 - mix) + sample * mix + gain


def to_device_fn(crappifier):
    """Lower a host :class:`Crappifier` to a ``(generator, images) ->
    images`` function, or None where the port has no device form of it."""
    if isinstance(crappifier, Poisson):
        return partial(poisson, intensity=crappifier.intensity, gain=crappifier.gain, spread=crappifier.spread)
    return None
