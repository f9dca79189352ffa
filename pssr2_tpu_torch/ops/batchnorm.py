"""BatchNorm over the last (channel) axis, train and eval mode
(counterpart: pssr2_tpu/ops/batchnorm.py: ``_stats`` 124, ``bn_train``
138-215, ``FastBatchNorm.apply_coeffs`` 298-323 and ``__call__`` 325-345).

Train mode normalizes with the batch statistics in f32 (``var =
max(0, E[x^2] - E[x]^2)``) and updates the running statistics with
momentum 0.9 (flax's convention; torch's 0.1) and the biased variance,
under no grad.  ``torch.nn.BatchNorm2d`` updates with the unbiased
variance, so it is not used.  Eval mode applies the running statistics
as one f32 affine.  ``model.train()`` / ``model.eval()`` toggle the mode.
The channel sums of the train-mode forward and backward, ``(sum x, sum
x^2)`` and ``(sum gy, sum gy x)``, are ``ops/chanstats.py``'s dual sums
(the chanstats kernel on the card), as JAX's ``_stats`` and ``bn_train``
take them from ``dual_sums``.
"""

import torch
from torch import nn

from .chanstats import channel_sums


def _stats(x):
    """f32 (mean, biased variance) over every axis but the last."""
    n = x.numel() // x.shape[-1]
    s = channel_sums(x, x)
    mu = s[0] / n
    var = torch.clamp(s[1] / n - mu * mu, min=0.0)
    return mu, var


class _BNTrain(torch.autograd.Function):
    """Train-mode BatchNorm with the analytic backward of ``bn_train``:
    two channel sums of the cotangent and one affine pass."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        mu, var = _stats(x)
        r = torch.rsqrt(var + eps)
        mul = r * scale.to(x.dtype).float()  # the JAX order: scale in x's dtype
        y = (x.float() - mu) * mul + bias.to(x.dtype).float()
        ctx.save_for_backward(x, scale, mu, var)
        ctx.eps = eps
        return y.to(x.dtype), mu, var

    @staticmethod
    def backward(ctx, gy, gmu, gvar):
        # y = (x - mu) r gamma + beta, mu and var the batch statistics of x.
        # With t0 = sum(gy), t1 = sum(gy x), s1 = t1 - mu t0, a = r gamma:
        #   dgamma = s1 r, dbeta = t0, dx = a gy + c2 x + c1 (c1, c2 below),
        # the cotangents of mu and var included.
        x, scale, mu, var = ctx.saved_tensors
        n = x.numel() // x.shape[-1]
        r = torch.rsqrt(var + ctx.eps)
        a = r * scale
        t0, t1 = channel_sums(gy.to(x.dtype), x)
        gyf, xf = gy.float(), x.float()
        s1 = t1 - mu * t0
        rr = r * r
        c2 = (-a * rr * s1 + 2.0 * gvar) / n
        c1 = (-a * t0 + a * rr * mu * s1 + gmu - 2.0 * gvar * mu) / n
        dx = (gyf * a + xf * c2 + c1).to(x.dtype)
        return dx, (s1 * r).to(scale.dtype), t0.to(scale.dtype), None


def bn_train(x, scale, bias, eps):
    """(y, mean, var) of train-mode BatchNorm over the last axis of ``x``:
    f32 statistics, ``y`` in x's dtype."""
    return _BNTrain.apply(x, scale, bias, eps)


class BatchNorm(nn.Module):
    """BatchNorm over the channel (last) axis of a channels-last tensor.

    Parameter and buffer names are those of ``torch.nn.BatchNorm2d``
    (``weight``, ``bias``, ``running_mean``, ``running_var``), without
    ``num_batches_tracked``, so the reference ``.pth`` layout loads with
    ``strict=True``."""

    MOMENTUM = 0.9  # running = MOMENTUM * running + (1 - MOMENTUM) * batch

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        f32 = {"device": device, "dtype": torch.float32}
        self.weight = nn.Parameter(torch.ones(num_features, **f32))
        self.bias = nn.Parameter(torch.zeros(num_features, **f32))
        self.register_buffer("running_mean", torch.zeros(num_features, **f32))
        self.register_buffer("running_var", torch.ones(num_features, **f32))
        self.eps = eps

    def _update_running(self, mu, var):
        m = self.MOMENTUM
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mu)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def apply_coeffs(self, s1=None, s2=None, count=None):
        """(a, b), f32 per-channel, with ``x*a + b`` equal to this BN's
        output, from the raw sums ``s1 = sum x``, ``s2 = sum x^2`` of the
        pre-BN tensor over ``count`` elements per channel (the convchain
        kernel's epilogue).  Train mode: batch statistics, the running
        update, and gradients that flow back into ``s1`` and ``s2``.  Eval
        mode: the running statistics (the sums may be None)."""
        if not self.training:
            a = torch.rsqrt(self.running_var + self.eps) * self.weight
            return a, self.bias - self.running_mean * a
        mu = s1 / count
        var = torch.clamp(s2 / count - mu * mu, min=0.0)
        self._update_running(mu.detach(), var.detach())
        a = torch.rsqrt(var + self.eps) * self.weight
        return a, self.bias - mu * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Channels-last ``x``; the output in x's dtype."""
        if not self.training:
            a, b = self.apply_coeffs()
            return (x.float() * a + b).to(x.dtype)
        y, mu, var = bn_train(x, self.weight, self.bias, self.eps)
        self._update_running(mu.detach(), var.detach())
        return y
