"""RDNet encoder (Revitalized DenseNet, Kim et al., 2024), channels-last
(counterpart: pssr2_tpu/models/rdnet.py; reference: pssr/models/_rdnet.py).

Module and parameter names follow the reference ``.pth`` layout that
pssr2_tpu/torch_import.py:171-198 describes: ``stem.stem.{0 conv, 1
norm}``; ``dense_stages.{i}`` = [LayerNorm2d, conv,] DenseStage, whose
blocks are ``dense_block{k}`` with ``gamma`` and ``layers.layers.{0 dw,
1 norm, 2 fc1, 3 GELU, 4 fc2, 5 ese}``.  The Sequentials hold parameters:
the forward passes are written out, channels-last.  Parameters are f32;
the compute runs in the input's dtype.

Each dense block's tail (LayerNorm -> fc1 -> GELU -> fc2) goes through
:func:`ops.rdtail.fused_rd_tail`, the CUDA kernels on the card; the 7x7
depthwise conv, the stem, the transitions and the squeeze-excitation are
plain PyTorch, as the JAX package leaves them to XLA.
"""

import numpy as np
import torch
from torch import nn

from ..ops.blockmath import _layernorm
from ..ops.rdtail import fused_rd_tail
from .blocks import conv_nhwc


class LayerNorm2d(nn.Module):
    """LayerNorm over the channel (last) axis, flax ``nnx.LayerNorm``
    semantics (eps 1e-6): scale and bias rounded to the input's dtype, f32
    statistics with the fast variance, the output in the input's dtype."""

    def __init__(self, features, eps=1e-6, *, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.eps = eps

    def forward(self, x):
        return _layernorm(x, self.weight, self.bias, self.eps)


class DropPath(nn.Module):
    """Stochastic depth: in train mode each sample's branch is kept with
    probability 1 - rate and scaled by 1/(1 - rate), or zeroed (``nnx.Dropout``
    broadcast over H, W, C).  Identity at rate 0 and in eval mode.  The keep
    mask is drawn on the host from ``generator``, a CPU ``torch.Generator``
    (one seeded with 0 when None), and moved to the input's device."""

    def __init__(self, rate, *, generator=None):
        super().__init__()
        self.rate = rate
        self.generator = torch.Generator().manual_seed(0) if generator is None else generator

    def forward(self, x):
        if self.rate == 0 or not self.training:
            return x
        keep = 1.0 - self.rate
        u = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=self.generator).to(x.device)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class EffectiveSE(nn.Module):
    """Effective squeeze-excitation: x * clip(fc(mean_HW x) + 3, 0, 6) / 6."""

    def __init__(self, channels, *, device=None):
        super().__init__()
        self.fc = nn.Conv2d(channels, channels, 1, device=device)

    def forward(self, x):
        se = conv_nhwc(x.mean(dim=(1, 2), keepdim=True), self.fc)
        return x * (torch.clamp(se + 3.0, 0.0, 6.0) / 6.0)


class Block(nn.Module):
    """7x7 depthwise conv -> LayerNorm -> fc1 -> GELU -> fc2 (-> ESE)
    (reference: _rdnet.py:177-190), the tail fused."""

    def __init__(self, in_chs, inter_chs, out_chs, ese=False, *, device=None):
        super().__init__()
        layers = [
            nn.Conv2d(in_chs, in_chs, 7, padding=3, groups=in_chs, device=device),
            LayerNorm2d(in_chs, device=device),
            nn.Conv2d(in_chs, inter_chs, 1, device=device),
            nn.GELU(),
            nn.Conv2d(inter_chs, out_chs, 1, device=device),
        ]
        if ese:
            layers.append(EffectiveSE(out_chs, device=device))
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        dw, norm, fc1, _, fc2 = self.layers[:5]
        x = conv_nhwc(x, dw)
        n, h, w, c = x.shape
        inter, out = fc1.out_channels, fc2.out_channels
        y = fused_rd_tail(
            x.reshape(n * h * w, c), norm.weight, norm.bias, fc1.weight.view(inter, c).t(), fc1.bias,
            fc2.weight.view(out, inter).t(), fc2.bias, eps=norm.eps,
        )
        x = y.view(n, h, w, out)
        if len(self.layers) > 5:
            x = self.layers[5](x)
        return x


class DenseBlock(nn.Module):
    """A Block scaled by the layer scale ``gamma`` (reference:
    _rdnet.py:140-175); its DropPath is applied by the stage."""

    def __init__(self, num_input_features, growth_rate, bottleneck_width_ratio, drop_path_rate, ese=False,
                 ls_init_value=1e-6, *, device=None, generator=None):
        super().__init__()
        self.gamma = (
            nn.Parameter(ls_init_value * torch.ones(growth_rate, device=device)) if ls_init_value > 0 else None
        )
        inter_chs = int(num_input_features * bottleneck_width_ratio / 8) * 8
        self.drop_path = DropPath(drop_path_rate, generator=generator)
        self.layers = Block(num_input_features, inter_chs, growth_rate, ese=ese, device=device)

    def forward(self, x):
        x = self.layers(x)
        if self.gamma is not None:
            x = x * self.gamma.to(x.dtype)
        return x


class DenseStage(nn.Module):
    """Dense feature concatenation over blocks (reference: _rdnet.py:118-138)."""

    def __init__(self, num_block, num_input_features, growth_rate, drop_path_rates, ese, bottleneck_width_ratio,
                 ls_init_value, *, device=None, generator=None):
        super().__init__()
        for i in range(num_block):
            self.add_module(
                f"dense_block{i}",
                DenseBlock(num_input_features, growth_rate, bottleneck_width_ratio, drop_path_rates[i], ese=ese,
                           ls_init_value=ls_init_value, device=device, generator=generator),
            )
            num_input_features += growth_rate
        self.num_out_features = num_input_features

    def forward(self, x):
        features = [x]
        for block in self.children():
            new = block(torch.cat(features, dim=-1) if len(features) > 1 else features[0])
            features.append(block.drop_path(new))
        return torch.cat(features, dim=-1)


class PatchifyStem(nn.Module):
    """patch_size x patch_size conv with that stride, then LayerNorm
    (reference: _rdnet.py:106-116)."""

    def __init__(self, in_channels, num_init_features, patch_size, *, device=None):
        super().__init__()
        self.stem = nn.Sequential(
            nn.Conv2d(in_channels, num_init_features, patch_size, stride=patch_size, device=device),
            LayerNorm2d(num_init_features, device=device),
        )

    def forward(self, x):
        return self.stem[1](conv_nhwc(x, self.stem[0]))


class RDNet(nn.Module):
    """(reference: _rdnet.py:15-104).  Forward returns (*skips, x), a skip
    taken before each downsampling stage.  ``generator``, a CPU
    ``torch.Generator`` (one seeded with 0 when None), draws every block's
    DropPath mask in turn."""

    def __init__(
        self,
        in_channels=1,
        n_init_features=128,
        patch_size=2,
        growth_rates=(64, 104, 128, 128, 128, 128, 224),
        ds_blocks=(False, True, True, False, False, False, True),
        ese_blocks=(False, False, True, True, True, True, True),
        n_blocks=(3, 3, 3, 3, 3, 3, 3),
        bottleneck_width_ratio=4,
        drop_path_rate=0.0,
        transition_compression_ratio=0.5,
        ls_init_value=1e-6,
        *,
        device=None,
        generator=None,
    ):
        super().__init__()
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        ese_blocks = [bool(b) for b in ese_blocks]
        n_blocks = [n_blocks] * len(growth_rates) if isinstance(n_blocks, int) else list(n_blocks)
        for name, other in (("ds_blocks", ds_blocks), ("ese_blocks", ese_blocks), ("n_blocks", n_blocks)):
            if len(growth_rates) != len(other):
                raise ValueError(
                    f"growth_rates and {name} must have the same length. Given values are "
                    f"{len(growth_rates)} and {len(other)} respectively."
                )

        self.stem = PatchifyStem(in_channels, n_init_features, patch_size, device=device)
        self.feature_info = []
        self.num_stages = len(growth_rates)
        curr_stride = 4  # the reference's stem stride bookkeeping
        num_features = n_init_features

        # linearly spaced drop-path rates over all blocks, split per stage
        flat_rates = np.linspace(0, drop_path_rate, sum(n_blocks)).tolist()
        dp_rates, pos = [], 0
        for nb in n_blocks:
            dp_rates.append(flat_rates[pos : pos + nb])
            pos += nb

        self.dense_stages = nn.ModuleList()
        for i in range(self.num_stages):
            parts = []
            if i != 0:
                compressed = int(num_features * transition_compression_ratio / 8) * 8
                k = 2 if ds_blocks[i] else 1
                if ds_blocks[i]:
                    curr_stride *= 2
                parts += [
                    LayerNorm2d(num_features, device=device),
                    nn.Conv2d(num_features, compressed, k, stride=k, device=device),
                ]
                num_features = compressed
            parts.append(
                DenseStage(n_blocks[i], num_features, growth_rates[i], dp_rates[i], ese_blocks[i],
                           bottleneck_width_ratio, ls_init_value, device=device, generator=generator)
            )
            self.dense_stages.append(nn.Sequential(*parts))
            num_features += n_blocks[i] * growth_rates[i]
            if i + 1 == self.num_stages or ds_blocks[i + 1]:
                self.feature_info.append(
                    dict(num_chs=num_features, reduction=curr_stride, module=f"dense_stages.{i}",
                         growth_rate=growth_rates[i])
                )
        self.ds_blocks = list(ds_blocks)

    def forward(self, x):
        x = self.stem(x)
        skips = []
        for idx, stage in enumerate(self.dense_stages):
            if self.ds_blocks[idx]:
                skips.append(x)
            if len(stage) == 3:
                norm, cv, _ = stage
                x = conv_nhwc(norm(x), cv)
            x = stage[-1](x)
        return (*skips, x)
