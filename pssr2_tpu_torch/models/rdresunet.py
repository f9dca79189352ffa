"""RDResUNet: RDNet encoder + ResUNet decoder (counterpart:
pssr2_tpu/models/rdresunet.py:21-181; reference: pssr/models/rdresunet.py).

NCHW float [0, 255] in and out, NHWC inside, as the port's ResUNet.
Encoder skips are taken from ``feature_info`` (reversed); the decoder's
pixel-shuffle ratios are ``[1, 2, ..., 2, patch_size]``.  The decoder's
ResBlocks run the convchain kernels, the encoder's dense blocks the
fused tail (``ops/rdtail.py``).  A new model is in eval mode;
``model.train()`` switches the BatchNorms to batch statistics and turns
DropPath on.
"""

import torch
from torch import nn

from .. import resolve_device
from ..ops.shuffle import pixel_shuffle
from .blocks import Reconstruction, ResBlock, batch_norm
from .rdnet import RDNet


class RDResUNet(nn.Module):
    def __init__(
        self,
        channels=1,
        hidden=None,
        scale: int = 4,
        depth: int = 3,
        dilations=None,
        pool_sizes=None,
        encoder_pool: bool = False,
        rdnet_init: int = 128,
        growth_rates=None,
        ds_blocks=None,
        ese_blocks=None,
        n_blocks=3,
        patch_size: int = 2,
        bottleneck: int = 4,
        compression: float = 0.5,
        drop_rate: float = 0,
        *,
        dtype=None,
        device=None,
    ):
        """RDNet (Revitalized DenseNet) encoder with a ResUNet decoder and an
        image upscaling head; the JAX package's argument surface and checks.

        Args:
            channels (int | list[int]) : Image channels, or [in, out]. Default 1.

            hidden (list[int]) : Decoder channels per residual block, one
                more than the downsampling dense stages. Default
                [1024, 1024, 512, 256].

            scale (int) : Upscaling factor. Default 4.

            depth (int) : Hidden layers per residual block. Default 3.

            dilations, pool_sizes, encoder_pool : the atrous and PSP
                variants (RDResUNetA); not ported yet.

            rdnet_init (int) : Channels of the RDNet stem. Default 128.

            growth_rates, ds_blocks, ese_blocks, n_blocks : per dense stage,
                its growth rate, whether it downsamples, whether its blocks
                end in an effective squeeze-excitation, and its block count.
                Defaults (64, 104, 128, 128, 128, 128, 224), (F, T, T, F, F,
                F, T), (F, F, T, T, T, T, T) and 3.

            patch_size (int) : Stem patch size. Default 2.

            bottleneck (int) : fc1 width over a dense block's input. Default 4.

            compression (float) : Transition channel ratio. Default 0.5.

            drop_rate (float) : Largest stochastic-depth rate. Default 0.

            dtype : Compute dtype (None = float32, or torch.bfloat16).
                Parameters stay float32.

            device : "cuda" (the default) or "cpu".
        """
        super().__init__()
        if dilations or pool_sizes or encoder_pool:
            raise NotImplementedError("RDResUNetA (dilations) and PSP pooling are not ported yet")
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, torch.float32 or torch.bfloat16, got {dtype}")
        device = resolve_device(device)
        hidden = [1024, 1024, 512, 256] if hidden is None else list(hidden)
        growth_rates = [64, 104, 128, 128, 128, 128, 224] if growth_rates is None else growth_rates
        ds_blocks = [False, True, True, False, False, False, True] if ds_blocks is None else ds_blocks
        ese_blocks = [False, False, True, True, True, True, True] if ese_blocks is None else ese_blocks
        channels = list(channels) if isinstance(channels, (list, tuple)) else [channels]
        channels = channels * 2 if len(channels) == 1 else channels

        self.norm = batch_norm(channels[0], device=device)
        if sum(ds_blocks) != len(hidden) - 1:
            raise ValueError(
                f"Number of downsampling blocks must be one less than ResUNet hidden layers. "
                f"Given {sum(ds_blocks)} downsampling blocks but {len(hidden)} hidden layers."
            )
        self.encoder = RDNet(
            channels[0], rdnet_init, patch_size, growth_rates, ds_blocks, ese_blocks, n_blocks, bottleneck,
            drop_rate, compression, device=device,
        )
        skips = [feature["num_chs"] for feature in self.encoder.feature_info][::-1]
        if len(skips) != len(hidden):
            raise ValueError(
                f"Each encoder skip connection must have a corresponding decoder hidden layer. "
                f"There are {len(skips)} skip connections but {len(hidden)} hidden layers."
            )
        self.ratios = [1] + [2] * (len(skips) - 1) + [patch_size]
        layers = [0, *hidden]
        self.decoder = nn.ModuleList(
            ResBlock(layers[i] // self.ratios[i] ** 2 + skips[i], layers[i + 1], depth, device=device)
            for i in range(len(layers) - 1)
        )
        self.reconstruction = Reconstruction(
            channels[0], channels[1], hidden[-1] // self.ratios[-1] ** 2, scale, device=device
        )
        self.skips = skips
        self.scale = scale
        self.depth = depth
        self.channels = channels
        self.dtype = dtype
        self.eval()

    def forward(self, x):
        """(N, C, H, W) float [0, 255] -> (N, C_out, H*scale, W*scale) float32."""
        x = (x.float() / 128.0 - 1.0).permute(0, 2, 3, 1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = self.norm(x.contiguous())

        skips = [x, *self.encoder(x)]
        for idx, layer in enumerate(self.decoder):
            x = torch.cat([x, skips.pop()], dim=-1) if idx != 0 else skips.pop()
            x = pixel_shuffle(layer(x), self.ratios[idx + 1])
        x = self.reconstruction(torch.cat([x, skips.pop()], dim=-1))
        return x.permute(0, 3, 1, 2).float() * 128.0 + 128.0
