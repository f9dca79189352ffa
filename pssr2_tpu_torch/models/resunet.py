"""ResUNet super-resolution model (counterpart:
pssr2_tpu/models/resunet.py:66-228; reference: pssr/models/resunet.py).

NCHW float [0, 255] in and out (``x/128 - 1`` in front, ``*128 + 128``
behind), NHWC inside.  Parameters are f32; ``dtype=torch.bfloat16`` runs
the compute in bf16, as the JAX ``dtype`` argument does.  A new model is
in eval mode; ``model.train()`` switches every BatchNorm to batch
statistics (and the ResBlock convs to a stop-gradient bias), as the JAX
model's ``train()`` does.
"""

import torch
from torch import nn

from .. import resolve_device
from ..ops.pooling import max_pool_2x2
from ..ops.shuffle import pixel_shuffle
from .blocks import Reconstruction, ResBlock, batch_norm


class ResUNet(nn.Module):
    def __init__(
        self,
        channels=1,
        hidden=None,
        scale: int = 4,
        depth: int = 3,
        dilations=None,
        pool_sizes=None,
        encoder_pool: bool = False,
        *,
        dtype=None,
        device=None,
    ):
        """A Residual UNet with an image upscaling head.

        Args:
            channels (int | list[int]) : Image channels, or [in, out]. Default 1.

            hidden (list[int]) : Channels per residual block. Default
                [64, 128, 256, 512, 1024].

            scale (int) : Upscaling factor. Default 4.

            depth (int) : Hidden layers per residual block. Default 3.

            dilations, pool_sizes, encoder_pool : the atrous and PSP
                variants; not ported yet.

            dtype : Compute dtype (None = float32, or torch.bfloat16).
                Parameters stay float32.

            device : "cuda" (the default) or "cpu".
        """
        super().__init__()
        if dilations or pool_sizes or encoder_pool:
            raise NotImplementedError("ResUNetA (dilations) and PSP pooling are not ported yet")
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, torch.float32 or torch.bfloat16, got {dtype}")
        device = resolve_device(device)
        hidden = [64, 128, 256, 512, 1024] if hidden is None else list(hidden)
        channels = list(channels) if isinstance(channels, (list, tuple)) else [channels]
        channels = channels * 2 if len(channels) == 1 else channels

        self.norm = batch_norm(channels[0], device=device)
        self.encoder, self.decoder = nn.ModuleList(), nn.ModuleList()
        layers = [channels[0], *hidden]
        n_layers = len(layers) - 1
        for i in range(n_layers):
            self.encoder.append(ResBlock(layers[i], layers[i + 1], depth, device=device))
            if i + 1 < n_layers:
                # decoder input: pixel-shuffled deep features + the skip
                self.decoder.append(
                    ResBlock(
                        layers[-i - 1] - int(layers[-i - 2] / 2), layers[-i - 2], depth, device=device
                    )
                )
        self.reconstruction = Reconstruction(channels[0], channels[1], hidden[0], scale, device=device)
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

        skips = [x]
        for i, layer in enumerate(self.encoder):
            x = layer(x)
            if i + 1 < len(self.encoder):
                skips.append(x)
                x = max_pool_2x2(x)
        for layer in self.decoder:
            x = torch.cat([pixel_shuffle(x, 2), skips.pop()], dim=-1)
            x = layer(x)
        x = self.reconstruction(torch.cat([x, skips.pop()], dim=-1))
        return x.permute(0, 3, 1, 2).float() * 128.0 + 128.0
