"""Model blocks (counterpart: pssr2_tpu/models/blocks.py:37-105,
108-335), channels-last inside, in train and eval mode.

Module and parameter names follow the reference ``.pth`` layout that
pssr2_tpu/torch_import.py:51-80 describes (``conv.{3i}`` conv,
``conv.{3i+1}`` BatchNorm, ``respass``; ``reconstruction.pre`` /
``reconstruction.conv``), so a reference ``state_dict`` loads strictly.
Parameters are f32; ``dtype`` is the compute type.
"""

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.batchnorm import BatchNorm
from ..ops.chanstats import channel_sums
from ..ops.convchain import fused_conv_layer
from ..ops.shuffle import pixel_shuffle


def conv(in_features, out_features, kernel_size, *, device=None):
    """3x3/1x1 conv parameter holder with torch's default init."""
    return nn.Conv2d(
        in_features, out_features, kernel_size, padding=kernel_size // 2, device=device
    )


def batch_norm(features, *, device=None, eps=1e-5):
    return BatchNorm(features, eps=eps, device=device)


def conv_nhwc(x, layer: nn.Conv2d):
    """``layer`` on a channels-last tensor in x's dtype: the conv rounds to
    the dtype first, then the bias is added in the dtype (the JAX conv's
    order).  For the convs that no TPU kernel computed: the 1x1
    ``respass``, the reconstruction head, and RDNet's stem, transitions,
    depthwise 7x7 and squeeze-excitation."""
    dt = x.dtype
    y = F.conv2d(
        x.permute(0, 3, 1, 2), layer.weight.to(dt), padding=layer.padding, stride=layer.stride,
        groups=layer.groups,
    )
    return y.permute(0, 2, 3, 1) + layer.bias.to(dt)


class Reconstruction(nn.Module):
    """conv -> ReLU -> pixel_shuffle(scale) -> conv upscale head
    (reference: pssr/models/_blocks.py:6-18).  The JAX package evaluates
    the same function in a TPU form (ops/smallconv.fused_upsample_tail)."""

    def __init__(self, in_channels, out_channels, hidden, scale=4, *, device=None):
        super().__init__()
        self.pre = conv(hidden + in_channels, scale**2 * hidden, 3, device=device)
        self.conv = conv(hidden, out_channels, 3, device=device)
        self.scale = scale

    def forward(self, x):
        x = torch.relu(conv_nhwc(x, self.pre))
        return conv_nhwc(pixel_shuffle(x, self.scale), self.conv)


class _ChannelAffine(torch.autograd.Function):
    """``(h.float() * a + b).to(h.dtype)`` for f32 per-channel ``a``, ``b``,
    with the backward in one pass over ``gy`` and ``h``: ``[db, da] = [sum
    gy, sum gy h]`` per channel (``ops/chanstats.py``, the chanstats kernel
    on the card) and ``dh = gy a``."""

    @staticmethod
    def forward(ctx, h, a, b):
        ctx.save_for_backward(h, a)
        return (h.float() * a + b).to(h.dtype)

    @staticmethod
    def backward(ctx, gy):
        h, a = ctx.saved_tensors
        db, da = channel_sums(gy, h)
        return (gy.float() * a).to(h.dtype), da, db


class ResBlock(nn.Module):
    """Conv stack with BatchNorm and a residual 1x1 pass
    (reference: pssr/models/_blocks.py:20-41).

    Every 3x3 layer goes through the convchain kernels, forward and
    backward.  Layer i's BatchNorm apply and ReLU ride as layer i+1's
    prologue, as ``_convchain_call`` (pssr2_tpu/models/blocks.py:238-333)
    chains them; the BatchNorm takes its statistics from the kernel's
    (sum, sum of squares) in train mode.  There the conv bias is added
    under stop-gradient (``SGBiasConv``, blocks.py:37-105): a train-mode
    BatchNorm cancels it, so its gradient is exactly zero.  The last
    layer's BatchNorm apply is a per-channel affine whose backward takes
    its two channel sums from the chanstats kernel; the residual pass and
    the final ReLU are plain PyTorch.
    """

    def __init__(self, in_channels, out_channels, depth, *, device=None):
        super().__init__()
        self.n_layers = max(depth, 0) + 1
        layers = []
        for i in range(self.n_layers):
            layers.append(conv(in_channels if i == 0 else out_channels, out_channels, 3, device=device))
            layers.append(batch_norm(out_channels, device=device))
            if i + 1 < self.n_layers:
                layers.append(nn.ReLU())
        self.conv = nn.Sequential(*layers)
        self.respass = conv(in_channels, out_channels, 1, device=device)
        self.depth = depth

    def forward(self, x):
        count = x.shape[0] * x.shape[1] * x.shape[2]
        h, ab = x, None
        for i in range(self.n_layers):
            cv, norm = self.conv[3 * i], self.conv[3 * i + 1]
            bias = cv.bias.detach() if norm.training else cv.bias
            h, s1, s2 = fused_conv_layer(h, cv.weight, bias, ab)
            a, b = norm.apply_coeffs(s1, s2, count)
            ab = torch.stack([a, b])
        h = _ChannelAffine.apply(h, ab[0], ab[1])
        return torch.relu(h + conv_nhwc(x, self.respass))
