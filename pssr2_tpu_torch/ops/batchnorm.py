"""Eval-mode BatchNorm as a per-channel f32 affine
(counterpart: pssr2_tpu/ops/batchnorm.py:299-315, the running-stat branch
of ``FastBatchNorm.apply_coeffs``).  Train-mode statistics belong to the
training slice."""

import torch
from torch import nn


class BatchNorm(nn.Module):
    """Running-stat BatchNorm whose apply is ``y = x*a + b`` with
    ``a = rsqrt(var + eps) * scale`` and ``b = bias - mean * a`` in f32.

    Parameter and buffer names are those of ``torch.nn.BatchNorm2d``
    (``weight``, ``bias``, ``running_mean``, ``running_var``), without
    ``num_batches_tracked``, so the reference ``.pth`` layout loads with
    ``strict=True``."""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        f32 = {"device": device, "dtype": torch.float32}
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))
        self.eps = eps

    def apply_coeffs(self):
        """(a, b), f32 per-channel, with ``x*a + b`` equal to this BN's output."""
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        return a, self.bias - self.running_mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-last ``x``: the affine in f32, rounded once to x's dtype."""
        a, b = self.apply_coeffs()
        return (x.float() * a + b).to(x.dtype)
