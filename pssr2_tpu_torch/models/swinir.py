"""SwinIR (Liang et al., 2021), channels-last inside (counterpart:
pssr2_tpu/models/swinir.py; reference: pssr/models/swinir.py).

Shifted-window attention with the relative-position bias, RSTB residual
groups, the four upsampler heads, the reflect pad to a window multiple, and
the PSSR convention that the model works on [0, 255] values directly
(img_range 1, mean 0).  NCHW float in and out; parameters f32, ``dtype``
the compute type.  Module and parameter names follow the reference ``.pth``
layout that pssr2_tpu/torch_import.py:106-161 describes; the buffers
``relative_position_index`` and ``attn_mask`` are recomputed, not stored
(the index is a non-persistent buffer).
The shift mask (``_shift_attn_mask`` at swinir.py:71) is
``ops/winattn.shift_attn_mask``, which the plain block shares.

Routing inside a :class:`BasicLayer`, in the JAX package's order of
preference (pssr2_tpu/models/swinir.py:425-514):

1. the whole-block chain, one ``ops/swinblock.fused_swin_block`` per block
   (the CUDA kernels on the card), when the window is uniform, every shift
   is 0 or ws/2, the elementwise dropouts are inactive and the block fits
   the kernels (``swinblock.fits``).  In train mode DropPath rides along as
   per-sample keep-scales and the backward kernel computes the gradients;
2. otherwise, in eval, the per-block path with the window-attention kernel
   (``ops/winattn``) as its attention core; LayerNorm, the projections and
   the MLP are plain PyTorch there, as in JAX;
3. otherwise, in training, the plain per-block path under autograd (JAX's
   XLA path), with ``torch.utils.checkpoint`` per block when
   ``use_checkpoint``.

The JAX package's TPU-only gates are means, not semantics, and have no
counterpart here: ``MIN_GRID_ROWS`` and ``MIN_BATCH`` (the batch below
which its kernels lost to XLA on the TPU), the VMEM bound ``ws * W * C <=
2**18``, the backend test and ``n % 8``.  Likewise the TPU's roll-space
chain: a block here takes and returns the canonical layout.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .. import resolve_device
from ..ops import swinblock, winattn
from ..ops.blockmath import _matmul
from ..ops.shuffle import pixel_shuffle
from .blocks import conv_nhwc
from .rdnet import LayerNorm2d as LayerNorm

def window_partition(x, window_size):
    """(B, H, W, C) -> (num_windows * B, ws, ws, C) (reference: swinir.py:472-485)."""
    b, h, w, c = x.shape
    return winattn.windows(x, window_size).reshape(-1, window_size, window_size, c)


def window_reverse(windows, window_size, h, w):
    """Inverse of :func:`window_partition` (reference: swinir.py:487-500)."""
    b = windows.shape[0] // (h * w // window_size // window_size)
    return winattn.unwindows(windows.reshape(-1, window_size * window_size, windows.shape[-1]), window_size, b, h, w)


@functools.lru_cache(maxsize=32)
def _relative_position_index(wh, ww):
    """(wh ww, wh ww) index into the (2wh - 1)(2ww - 1)-row bias table."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def _linear(in_f, out_f, bias=True, *, device):
    """nn.Linear with the JAX init: truncated normal (std 0.02, cut at 2
    std) weights, zero bias."""
    layer = nn.Linear(in_f, out_f, bias=bias, device=device)
    nn.init.trunc_normal_(layer.weight, std=0.02, a=-0.04, b=0.04)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _lin(x, layer):
    """``layer`` on the last axis in x's dtype (nnx.Linear's rounding)."""
    bias = layer.bias if layer.bias is not None else torch.zeros(layer.out_features, device=x.device)
    return _matmul(x, layer.weight.t(), bias)


def _dropout(rate):
    return nn.Dropout(rate) if rate > 0 else None


class Mlp(nn.Module):
    def __init__(self, in_features, hidden_features, drop=0.0, *, device=None):
        super().__init__()
        self.fc1 = _linear(in_features, hidden_features, device=device)
        self.fc2 = _linear(hidden_features, in_features, device=device)
        self.drop = _dropout(drop)

    def forward(self, x):
        x = F.gelu(_lin(x, self.fc1))
        if self.drop is not None:
            x = self.drop(x)
        x = _lin(x, self.fc2)
        return x if self.drop is None else self.drop(x)


class WindowAttention(nn.Module):
    """W-MSA with the relative-position bias (reference: swinir.py:516-597)."""

    def __init__(self, dim, window_size, num_heads, qkv_bias=True, qk_scale=None, attn_drop=0.0, proj_drop=0.0,
                 *, device=None):
        super().__init__()
        self.dim = dim
        self.window_size = window_size  # (wh, ww)
        self.num_heads = num_heads
        self.scale = qk_scale or (dim // num_heads) ** -0.5
        n_bias = (2 * window_size[0] - 1) * (2 * window_size[1] - 1)
        self.relative_position_bias_table = nn.Parameter(torch.empty(n_bias, num_heads, device=device))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02, a=-0.04, b=0.04)
        # on the module's device, so that gathering the bias map copies nothing from the host
        self.register_buffer("relative_position_index", torch.from_numpy(
            _relative_position_index(*window_size).reshape(-1).copy()).to(device), persistent=False)
        self.qkv = _linear(dim, dim * 3, bias=qkv_bias, device=device)
        self.proj = _linear(dim, dim, device=device)
        self.attn_drop = _dropout(attn_drop)
        self.proj_drop = _dropout(proj_drop)

    def bias_map(self):
        """(heads, n, n) f32, gathered from the table (differentiable)."""
        n = self.window_size[0] * self.window_size[1]
        return self.relative_position_bias_table[self.relative_position_index].reshape(n, n, -1).permute(2, 0, 1)

    def _out(self, x):
        x = _lin(x, self.proj)
        return x if self.proj_drop is None else self.proj_drop(x)

    def forward_image(self, x_img, mask_spec=None):
        """(B, H, W, C) -> (B, H, W, C) through the window-attention kernel,
        the windows read in place (swinir.py:139)."""
        ws = self.window_size[0]
        out = winattn.fused_window_attention_2d(_lin(x_img, self.qkv), self.bias_map(), mask_spec, self.scale,
                                                self.num_heads, ws)
        return self._out(out)

    def forward(self, x, mask=None):
        """(W, n, C) windows, the plain formulation (swinir.py:157): q scaled
        in the dtype, scores and softmax in the dtype; mask (nW, n, n) or None."""
        b_, n, c = x.shape
        heads = self.num_heads
        q, k, v = (t.transpose(1, 2) for t in winattn.split_qkv(_lin(x, self.qkv), heads))  # (b_, n, h, d)
        attn = torch.einsum("bnhd,bmhd->bhnm", q * self.scale, k)
        attn = attn + self.bias_map()[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, heads, n, n) + mask[None, :, None].to(attn.dtype)).reshape(-1, heads, n, n)
        attn = torch.softmax(attn, dim=-1)
        if self.attn_drop is not None:
            attn = self.attn_drop(attn)
        return self._out(torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b_, n, c))


class DropPathTok(nn.Module):
    """Stochastic depth over (B, L, C) tokens (swinir.py:194): in train mode
    each sample's branch is kept with probability 1 - rate and scaled by
    1 / (1 - rate), or zeroed.  The keep masks are drawn on the host from
    ``generator``, a CPU ``torch.Generator`` the model shares among its
    blocks, so the card and the CPU draw alike."""

    def __init__(self, rate, *, generator=None):
        super().__init__()
        self.rate = rate
        self.generator = torch.Generator().manual_seed(0) if generator is None else generator

    def draw(self, b):
        """(B,) bool keep mask, or None when inactive (eval or rate 0)."""
        if self.rate == 0 or not self.training:
            return None
        return torch.rand((b,), generator=self.generator) < 1.0 - self.rate

    def scales(self, b, device):
        """The two (B,) f32 keep-scales mask / keep_prob of the attention and
        MLP branches, from two draws, or None (swinir.py:drop_path_scales
        at 312)."""
        keep = self.draw(b)
        if keep is None:
            return None
        s = torch.stack([keep, self.draw(b)]).float() / (1.0 - self.rate)
        if torch.device(device).type == "cuda":  # from pinned memory: the host does not wait for the card
            s = s.pin_memory().to(device, non_blocking=True)
        return s[0], s[1]

    def forward(self, x, keep=None):
        """x with the samples of ``keep`` (a :meth:`draw`) scaled, the rest zeroed."""
        if keep is None:
            return x
        keep = keep.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class SwinTransformerBlock(nn.Module):
    """(reference: swinir.py:270-389)"""

    def __init__(self, dim, input_resolution, num_heads, window_size=7, shift_size=0, mlp_ratio=4.0, qkv_bias=True,
                 qk_scale=None, drop=0.0, attn_drop=0.0, drop_path=0.0, *, device=None, generator=None):
        super().__init__()
        self.dim = dim
        self.input_resolution = input_resolution
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift_size = shift_size
        self.mlp_ratio = mlp_ratio
        if min(input_resolution) <= window_size:
            self.shift_size = 0
            self.window_size = min(input_resolution)
        assert 0 <= self.shift_size < self.window_size
        self.norm1 = LayerNorm(dim, device=device)
        self.attn = WindowAttention(dim, (self.window_size, self.window_size), num_heads, qkv_bias, qk_scale,
                                    attn_drop, drop, device=device)
        self.drop_path = DropPathTok(drop_path, generator=generator)
        self.norm2 = LayerNorm(dim, device=device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop, device=device)

    def fused_params(self):
        """The 13 operands of ``swinblock.fused_swin_block`` (swinir.py:229)."""
        a = self.attn
        qkv_bias = a.qkv.bias if a.qkv.bias is not None else torch.zeros(3 * self.dim, device=a.qkv.weight.device)
        return (self.norm1.weight, self.norm1.bias, a.qkv.weight.t(), qkv_bias, a.proj.weight.t(), a.proj.bias,
                self.norm2.weight, self.norm2.bias, self.mlp.fc1.weight.t(), self.mlp.fc1.bias,
                self.mlp.fc2.weight.t(), self.mlp.fc2.bias, a.bias_map())

    def forward_fused(self, x_img, scales=None):
        """The whole block on (B, H, W, C), canonical in and out."""
        return swinblock.fused_swin_block(
            x_img, self.fused_params(), heads=self.num_heads, scale=self.attn.scale, ws=self.window_size,
            shift=self.shift_size, eps=self.norm1.eps, scales=scales,
        )

    def forward(self, x, x_size, keep=None):
        """The per-block path on (B, L, C) tokens; ``keep`` the DropPath
        draws (attention branch, MLP branch) or None."""
        h, w = x_size
        b, _, c = x.shape
        ws, s = self.window_size, self.shift_size
        shortcut = x
        x = self.norm1(x).reshape(b, h, w, c)
        if s:
            x = torch.roll(x, (-s, -s), (1, 2))
        mask_spec = (h, w, ws, s) if s else None
        if not self.training and winattn.fits(ws * ws, c // self.num_heads):
            x = self.attn.forward_image(x, mask_spec)
        else:
            mask = winattn._mask_tensor(mask_spec, x.device)
            x = window_reverse(self.attn(window_partition(x, ws).reshape(-1, ws * ws, c), mask), ws, h, w)
        if s:
            x = torch.roll(x, (s, s), (1, 2))
        keep1, keep2 = (None, None) if keep is None else keep
        x = shortcut + self.drop_path(x.reshape(b, h * w, c), keep1)
        return x + self.drop_path(self.mlp(self.norm2(x)), keep2)


class PatchEmbed(nn.Module):
    """Image -> tokens (reference: swinir.py:641-672)."""

    def __init__(self, embed_dim, norm_layer=True, *, device=None):
        super().__init__()
        self.norm = LayerNorm(embed_dim, device=device) if norm_layer else None

    def forward(self, x):
        b, h, w, c = x.shape
        x = x.reshape(b, h * w, c)
        return x if self.norm is None else self.norm(x)


class PatchUnEmbed(nn.Module):
    """Tokens -> image (reference: swinir.py:674-702)."""

    def forward(self, x, x_size):
        return x.reshape(x.shape[0], x_size[0], x_size[1], x.shape[-1])


class BasicLayer(nn.Module):
    """A stage of Swin blocks (reference: swinir.py:391-454), with the
    routing of the module docstring."""

    def __init__(self, dim, input_resolution, depth, num_heads, window_size, mlp_ratio, qkv_bias, qk_scale, drop,
                 attn_drop, drop_path, use_checkpoint, *, device=None, generator=None):
        super().__init__()
        self.use_checkpoint = use_checkpoint
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(
                dim, input_resolution, num_heads, window_size, 0 if i % 2 == 0 else window_size // 2, mlp_ratio,
                qkv_bias, qk_scale, drop, attn_drop,
                drop_path[i] if isinstance(drop_path, (list, tuple)) else drop_path,
                device=device, generator=generator,
            )
            for i in range(depth)
        )

    def chain_ok(self, c):
        """Whether the whole-block chain takes this layer: a uniform window,
        shifts of 0 or ws/2, inactive elementwise dropouts (DropPath rides
        along as keep-scales) and the kernels' limits
        (swinir.py:_fused_chain_ok at 425, _fused_train_ok at 452)."""
        sizes = {blk.window_size for blk in self.blocks}
        if len(sizes) != 1:
            return False
        ws = sizes.pop()
        for blk in self.blocks:
            if blk.shift_size not in (0, ws // 2):
                return False
            drops = (blk.attn.attn_drop, blk.attn.proj_drop, blk.mlp.drop)
            if self.training and any(d is not None for d in drops):
                return False
        blk = self.blocks[0]
        return swinblock.fits(c, blk.mlp.fc1.out_features, blk.num_heads, ws)

    def forward(self, x, x_size):
        h, w = x_size
        b, _, c = x.shape
        if self.chain_ok(c):
            x_img = x.reshape(b, h, w, c)
            for blk in self.blocks:
                x_img = blk.forward_fused(x_img, blk.drop_path.scales(b, x.device))
            return x_img.reshape(b, h * w, c)
        for blk in self.blocks:
            keep = (blk.drop_path.draw(b), blk.drop_path.draw(b))
            if self.use_checkpoint and torch.is_grad_enabled():
                x = torch.utils.checkpoint.checkpoint(blk, x, x_size, keep, use_reentrant=False)
            else:
                x = blk(x, x_size, keep)
        return x


def _conv3(cin, cout, k=3, *, device):
    return nn.Conv2d(cin, cout, k, padding=k // 2, device=device)


def _three_convs(dim, *, device):
    """[conv 3x3 dim -> dim/4, LeakyReLU, 1x1, LeakyReLU, 3x3 -> dim] ('3conv')."""
    return nn.Sequential(_conv3(dim, dim // 4, device=device), nn.LeakyReLU(0.2),
                         _conv3(dim // 4, dim // 4, 1, device=device), nn.LeakyReLU(0.2),
                         _conv3(dim // 4, dim, device=device))


def _run_convs(x, convs):
    """A conv, or the '3conv' Sequential, on NHWC x in its dtype."""
    if isinstance(convs, nn.Conv2d):
        return conv_nhwc(x, convs)
    x = F.leaky_relu(conv_nhwc(x, convs[0]), 0.2)
    x = F.leaky_relu(conv_nhwc(x, convs[2]), 0.2)
    return conv_nhwc(x, convs[4])


class RSTB(nn.Module):
    """Residual Swin Transformer Block group (reference: swinir.py:391-454)."""

    def __init__(self, dim, input_resolution, depth, num_heads, window_size, mlp_ratio, qkv_bias, qk_scale, drop,
                 attn_drop, drop_path, use_checkpoint, resi_connection="1conv", *, device=None, generator=None):
        super().__init__()
        self.residual_group = BasicLayer(dim, input_resolution, depth, num_heads, window_size, mlp_ratio, qkv_bias,
                                         qk_scale, drop, attn_drop, drop_path, use_checkpoint, device=device,
                                         generator=generator)
        if resi_connection == "1conv":
            self.conv = _conv3(dim, dim, device=device)
        elif resi_connection == "3conv":
            self.conv = _three_convs(dim, device=device)
        else:
            raise ValueError(f"Unknown resi_connection {resi_connection}")
        self.patch_embed = PatchEmbed(dim, norm_layer=False)
        self.patch_unembed = PatchUnEmbed()

    def forward(self, x, x_size):
        img = self.patch_unembed(self.residual_group(x, x_size), x_size)
        return self.patch_embed(_run_convs(img, self.conv)) + x


def _nearest2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


class SwinIR(nn.Module):
    def __init__(
        self,
        image_size: int = 128,
        channels=1,
        scale: int = 4,
        embed_dim: int = 96,
        mlp_ratio: int = 2,
        depths=None,
        num_heads=None,
        window_size: int = 8,
        patch_size: int = 1,
        upsampler: str = "pixelshuffle",
        qkv_bias: bool = True,
        qk_scale: float = None,
        drop_rate: float = 0,
        attn_drop_rate: float = 0,
        drop_path_rate: float = 0.1,
        ape: bool = False,
        patch_norm: bool = True,
        use_checkpoint: bool = False,
        resi_connection: str = "1conv",
        *,
        dtype=None,
        device=None,
        generator=None,
    ):
        """SwinIR as detailed in Liang et al., 2021, with the JAX package's
        argument surface and checks (pssr2_tpu/models/swinir.py:556-690).

        Args:
            image_size (int) : Training image size; windows are clamped to it
                and ``ape`` is sized by it. Default 128.

            channels (int | list[int]) : Image channels, or [in, out]. Default 1.

            scale (int) : Upscaling factor (2^n or 3). Default 4.

            embed_dim (int) : Token width. Default 96.

            mlp_ratio (int) : MLP width over embed_dim. Default 2.

            depths, num_heads (list[int]) : Blocks and heads per RSTB.
                Default [4, 4, 4, 4] and [6, 6, 6, 6].

            window_size (int) : Attention window. Default 8.

            patch_size (int) : Must be 1, the reference's effective value.

            upsampler (str) : "pixelshuffle", "pixelshuffledirect",
                "nearest+conv", or anything else for the residual head
                without upsampling. Default "pixelshuffle".

            qkv_bias, qk_scale : The qkv projection's bias and the attention
                scale (None: head_dim^-0.5).

            drop_rate, attn_drop_rate (float) : Elementwise dropouts.

            drop_path_rate (float) : Largest stochastic-depth rate. Default 0.1.

            ape (bool) : Absolute position embedding. Default False.

            patch_norm (bool) : LayerNorm after the patch embedding. Default True.

            use_checkpoint (bool) : Recompute each block in the backward on
                the per-block path (the whole-block chain recomputes anyway).

            resi_connection (str) : "1conv" or "3conv". Default "1conv".

            dtype : Compute dtype (None = float32, or torch.bfloat16).
                Parameters stay float32.

            device : "cuda" (the default) or "cpu".

            generator : CPU ``torch.Generator`` of the DropPath draws (one
                seeded with 0 when None).
        """
        super().__init__()
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, torch.float32 or torch.bfloat16, got {dtype}")
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(0) if generator is None else generator
        depths = [4, 4, 4, 4] if depths is None else list(depths)
        num_heads = [6, 6, 6, 6] if num_heads is None else list(num_heads)
        if len(depths) != len(num_heads):
            raise ValueError(
                f"Lengths of depths and num_heads must be equal. Given lengths are {len(depths)} and "
                f"{len(num_heads)}."
            )
        if patch_size != 1:
            raise ValueError("patch_size must be 1 (matching the reference's effective behavior).")
        channels = list(channels) if isinstance(channels, (list, tuple)) else [channels]
        channels = channels * 2 if len(channels) == 1 else channels
        num_in_ch, num_out_ch = channels[0], channels[1]
        num_feat = 64
        self.img_range = 1.0
        self.upscale = scale
        self.upsampler = upsampler
        self.window_size = window_size
        self.num_layers = len(depths)
        self.embed_dim = embed_dim
        self.num_features = embed_dim
        self.mlp_ratio = mlp_ratio
        self.channels = channels
        self.dtype = dtype
        self.resi_connection = resi_connection
        self.patches_resolution = (image_size, image_size)

        self.conv_first = _conv3(num_in_ch, embed_dim, device=device)
        self.patch_embed = PatchEmbed(embed_dim, norm_layer=patch_norm, device=device)
        self.patch_unembed = PatchUnEmbed()
        self.absolute_pos_embed = None
        if ape:
            self.absolute_pos_embed = nn.Parameter(torch.empty(1, image_size * image_size, embed_dim, device=device))
            nn.init.trunc_normal_(self.absolute_pos_embed, std=0.02, a=-0.04, b=0.04)
        self.pos_drop = _dropout(drop_rate)

        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            RSTB(embed_dim, self.patches_resolution, depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias,
                 qk_scale, drop_rate, attn_drop_rate, dpr[sum(depths[:i]) : sum(depths[: i + 1])], use_checkpoint,
                 resi_connection, device=device, generator=generator)
            for i in range(self.num_layers)
        )
        self.norm = LayerNorm(embed_dim, device=device)
        if resi_connection == "1conv":
            self.conv_after_body = _conv3(embed_dim, embed_dim, device=device)
        elif resi_connection == "3conv":
            self.conv_after_body = _three_convs(embed_dim, device=device)
        else:
            raise ValueError(f"Unknown resi_connection {resi_connection}")

        if upsampler == "pixelshuffle":
            self.conv_before_upsample = nn.Sequential(_conv3(embed_dim, num_feat, device=device), nn.LeakyReLU())
            if (scale & (scale - 1)) == 0:
                ups = []
                for _ in range(int(np.log2(scale))):
                    ups += [_conv3(num_feat, 4 * num_feat, device=device), nn.PixelShuffle(2)]
            elif scale == 3:
                ups = [_conv3(num_feat, 9 * num_feat, device=device), nn.PixelShuffle(3)]
            else:
                raise ValueError(f"scale {scale} is not supported. Supported scales: 2^n and 3.")
            self.upsample = nn.Sequential(*ups)
            self.conv_last = _conv3(num_feat, num_out_ch, device=device)
        elif upsampler == "pixelshuffledirect":
            self.upsample = nn.Sequential(_conv3(embed_dim, scale**2 * num_out_ch, device=device),
                                          nn.PixelShuffle(scale))
        elif upsampler == "nearest+conv":
            self.conv_before_upsample = nn.Sequential(_conv3(embed_dim, num_feat, device=device), nn.LeakyReLU())
            self.conv_up1 = _conv3(num_feat, num_feat, device=device)
            self.conv_up2 = _conv3(num_feat, num_feat, device=device) if scale == 4 else None
            self.conv_hr = _conv3(num_feat, num_feat, device=device)
            self.conv_last = _conv3(num_feat, num_out_ch, device=device)
        else:
            self.conv_last = _conv3(embed_dim, num_out_ch, device=device)
        self.eval()

    def _check_image_size(self, x):
        """NCHW reflect pad at the bottom and right to a window multiple
        (reference: swinir.py:208-213), reflected again where the pad
        outgrows the image, as ``jnp.pad(mode="reflect")`` does."""
        for dim in (2, 3):
            size = x.shape[dim]
            pad = (self.window_size - size % self.window_size) % self.window_size
            if pad:
                i = np.arange(size + pad) % max(2 * size - 2, 1)
                i = np.where(i >= size, 2 * size - 2 - i, i)
                x = x.index_select(dim, torch.from_numpy(i).to(x.device))
        return x

    def _forward_features(self, x):
        x_size = (x.shape[1], x.shape[2])
        x = self.patch_embed(x)
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(x.dtype)
        if self.pos_drop is not None:
            x = self.pos_drop(x)
        for layer in self.layers:
            x = layer(x, x_size)
        return self.patch_unembed(self.norm(x), x_size)

    def _body(self, x):
        """conv_first, the RSTBs, the norm and conv_after_body, plus the
        long skip from conv_first's output."""
        first = conv_nhwc(x, self.conv_first)
        return _run_convs(self._forward_features(first), self.conv_after_body) + first

    def forward(self, x):
        """(N, C, H, W) float [0, 255] -> (N, C_out, H*scale, W*scale) float32."""
        h_in, w_in = x.shape[2], x.shape[3]
        x = self._check_image_size(x.float()).permute(0, 2, 3, 1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = x.contiguous()
        if self.upsampler == "pixelshuffle":
            x = self._body(x)
            x = F.leaky_relu(conv_nhwc(x, self.conv_before_upsample[0]), 0.01)
            s_up = 2 if (self.upscale & (self.upscale - 1)) == 0 else 3
            for up in self.upsample[::2]:
                x = pixel_shuffle(conv_nhwc(x, up), s_up)
            x = conv_nhwc(x, self.conv_last)
        elif self.upsampler == "pixelshuffledirect":
            x = self._body(x)
            x = pixel_shuffle(conv_nhwc(x, self.upsample[0]), self.upscale)
        elif self.upsampler == "nearest+conv":
            x = self._body(x)
            x = F.leaky_relu(conv_nhwc(x, self.conv_before_upsample[0]), 0.01)
            x = F.leaky_relu(conv_nhwc(_nearest2x(x), self.conv_up1), 0.2)
            if self.conv_up2 is not None:
                x = F.leaky_relu(conv_nhwc(_nearest2x(x), self.conv_up2), 0.2)
            x = conv_nhwc(F.leaky_relu(conv_nhwc(x, self.conv_hr), 0.2), self.conv_last)
        else:
            x = x + conv_nhwc(self._body(x), self.conv_last)
        x = x.permute(0, 3, 1, 2).float()
        return x[:, :, : h_in * self.upscale, : w_in * self.upscale]

    def extra_repr(self):
        return (f"SwinIR with {self.upscale}x upscaling\n"
                f"{self.num_layers} Swin Transformer blocks with embedding size {self.embed_dim}")
