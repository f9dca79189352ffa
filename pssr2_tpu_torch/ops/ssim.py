"""SSIM and MS-SSIM on NCHW batches, numerically matched to
``pytorch_msssim`` (counterpart: pssr2_tpu/ops/ssim.py).

Separable Gaussian window (11 taps by default), VALID blur, K = (0.01,
0.03); MS-SSIM over 5 levels with weights [0.0448, 0.2856, 0.3001, 0.2363,
0.1333], a 2x2 average pool between levels (pad = dim % 2) and relu on the
cs terms.  The blur is two band-matrix products and ``_moments_to_ssim``
carries its analytic VJP.  :func:`_ssim_parts` dispatches as the JAX
package does: 4-D maps that the kernels take (``ssimfused.auto_ok``: f32,
odd window, image at least the window) go through
``ops/ssimfused.ssim_parts``, which launches the fused kernel for a CUDA
tensor and takes this band-matrix form for a CPU tensor; any other input
(bf16 maps, say) takes the band-matrix form in its own dtype on any
device.  f32 is true f32: TF32 is off for the whole package, and the
variance terms ``E[x^2] - E[x]^2`` cancel badly in lower precision.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@functools.lru_cache(maxsize=16)
def _gaussian_window(win_size: int, win_sigma: float) -> np.ndarray:
    coords = np.arange(win_size, dtype=np.float32) - win_size // 2
    g = np.exp(-(coords**2) / (2 * win_sigma**2))
    return (g / g.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _band_matrix(size: int, win_size: int, win_sigma: float) -> np.ndarray:
    """(size, size - win + 1) banded Gaussian matrix: multiplying by it is a
    VALID 1-D Gaussian conv."""
    g = _gaussian_window(win_size, win_sigma)
    out = size - win_size + 1
    m = np.zeros((size, out), dtype=np.float32)
    for t in range(win_size):
        m[np.arange(out) + t, np.arange(out)] = g[t]
    return m


@functools.lru_cache(maxsize=16)
def _band_on(size: int, win_size: int, win_sigma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_band_matrix(size, win_size, win_sigma)).to(device)


def _blur(x: torch.Tensor, win_size: int, win_sigma: float) -> torch.Tensor:
    """Separable Gaussian blur over the last two dims, VALID, as two f32
    band-matrix products (over H, then over W)."""
    h, w = x.shape[-2], x.shape[-1]
    if min(h, w) < win_size:
        raise ValueError(
            f"Image spatial dims {(h, w)} are smaller than the SSIM window "
            f"({win_size}); pass a smaller win_size."
        )
    gh = _band_on(h, win_size, win_sigma, x.device).to(x.dtype)
    gw = _band_on(w, win_size, win_sigma, x.device).to(x.dtype)
    return torch.matmul(torch.matmul(gh.T, x), gw)


def _blur_same(x: torch.Tensor, win_size: int, win_sigma: float) -> torch.Tensor:
    """Same-size Gaussian blur over the last two dims: zero padding of
    (win_size - 1) / 2, then the VALID blur."""
    pad = (win_size - 1) // 2
    return _blur(F.pad(x, (pad, pad, pad, pad)), win_size, win_sigma)


def _moments_to_ssim_maps(mu1, mu2, xx_b, yy_b, xy_b, c1, c2):
    """(ssim_map, cs_map) from the five blurred moment maps."""
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = xx_b - mu1_sq
    sigma2_sq = yy_b - mu2_sq
    sigma12 = xy_b - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map, cs_map


class _MomentsToSSIM(torch.autograd.Function):
    """Per-channel (ssim, cs) means of the maps, with the hand-derived
    gradient (pssr2_tpu/ops/ssim.py:111-143) as one elementwise pass."""

    @staticmethod
    def forward(ctx, mu1, mu2, xx_b, yy_b, xy_b, c1, c2):
        ssim_map, cs_map = _moments_to_ssim_maps(mu1, mu2, xx_b, yy_b, xy_b, c1, c2)
        ctx.save_for_backward(mu1, mu2, xx_b, yy_b, xy_b)
        ctx.c = (c1, c2)
        return ssim_map.flatten(2).mean(-1), cs_map.flatten(2).mean(-1)

    @staticmethod
    def backward(ctx, g_s, g_cs):
        # With A1 = 2 mu1 mu2 + c1, B1 = mu1^2 + mu2^2 + c1, A2 = 2 sigma12 + c2,
        # B2 = sigma1^2 + sigma2^2 + c2, R = A1/B1, S = A2/B2:
        #   ssim = mean(R S), cs = mean(S)
        #   d/dA1 = gs S / B1;  d/dB1 = -gs S R / B1
        #   d/dA2 = t / B2;     d/dB2 = -t S / B2        with t = gs R + gcs
        #   g_xx = g_yy = dB2,  g_xy = 2 dA2,
        #   g_mu1 = 2 [mu2 (dA1 - dA2) + mu1 (dB1 - dB2)]   (and symmetrically)
        mu1, mu2, xx_b, yy_b, xy_b = ctx.saved_tensors
        c1, c2 = ctx.c
        n = mu1.shape[-2] * mu1.shape[-1]
        gs = (g_s / n)[..., None, None]
        gcs = (g_cs / n)[..., None, None]
        mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        a1 = 2 * mu1_mu2 + c1
        b1 = mu1_sq + mu2_sq + c1
        a2 = 2 * (xy_b - mu1_mu2) + c2
        b2 = (xx_b - mu1_sq) + (yy_b - mu2_sq) + c2
        r = a1 / b1
        s = a2 / b2
        t = gs * r + gcs
        da1 = gs * s / b1
        db1 = -da1 * r
        da2 = t / b2
        db2 = -da2 * s
        g_mu1 = 2 * (mu2 * (da1 - da2) + mu1 * (db1 - db2))
        g_mu2 = 2 * (mu1 * (da1 - da2) + mu2 * (db1 - db2))
        return g_mu1, g_mu2, db2, db2, 2 * da2, None, None


def _moments_to_ssim(mu1, mu2, xx_b, yy_b, xy_b, c1, c2):
    """(B, C) means of the SSIM and cs maps of (B, C, H', W') moments."""
    return _MomentsToSSIM.apply(mu1, mu2, xx_b, yy_b, xy_b, c1, c2)


def _ssim_parts(x, y, data_range, win_size, win_sigma, k):
    from . import ssimfused

    k1, k2 = k
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    if x.dim() == 4 and ssimfused.auto_ok(x, win_size):
        return ssimfused.ssim_parts(x, y, float(c1), float(c2), win_size, win_sigma)

    # one batched blur for all five moment maps, in the maps' dtype
    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=0)
    blurred = _blur(stacked, win_size, win_sigma)
    mu1, mu2, xx_b, yy_b, xy_b = torch.chunk(blurred, 5, dim=0)
    return _moments_to_ssim(mu1, mu2, xx_b, yy_b, xy_b, float(c1), float(c2))


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 255.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    k=(0.01, 0.03),
    size_average: bool = True,
    nonnegative: bool = False,
):
    """Single-scale SSIM over NCHW batches (pytorch_msssim ``ssim`` parity)."""
    s, _ = _ssim_parts(x, y, data_range, win_size, win_sigma, k)
    if nonnegative:
        s = torch.relu(s)
    return s.mean() if size_average else s.mean(1)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool, stride 2, with zero pad = dim % 2 (torch
    semantics: padded zeros count in the divisor, and for odd dims the
    trailing pad is dropped by the output-size floor, so only the front
    pad survives)."""
    x = F.pad(x, (x.shape[-1] % 2, 0, x.shape[-2] % 2, 0))
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).sum(dim=(3, 5)) / 4.0


def ms_ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 255.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    weights=None,
    k=(0.01, 0.03),
    size_average: bool = True,
):
    """Multi-scale SSIM over NCHW batches (pytorch_msssim ``ms_ssim`` parity).

    The smallest spatial dim must be > (win_size - 1) * 2**(levels-1).
    Where the kernels take the maps and H and W divide by 2**(levels-1),
    each level but the last runs ``ssimfused.fused_ssim_parts_pool`` (the
    pool inside the kernel); otherwise each level is ``_ssim_parts`` and
    ``_avg_pool2``.
    """
    from . import ssimfused

    weights = torch.as_tensor(_MS_WEIGHTS if weights is None else weights, dtype=x.dtype, device=x.device)
    levels = weights.shape[0]
    smaller = min(x.shape[-2], x.shape[-1])
    if smaller <= (win_size - 1) * (2 ** (levels - 1)):
        raise ValueError(
            f"Image size {tuple(x.shape[-2:])} too small for {levels}-level MS-SSIM "
            f"with win_size={win_size}; needs > {(win_size - 1) * 2 ** (levels - 1)}."
        )
    fused_chain = (
        x.dim() == 4
        and ssimfused.auto_ok(x, win_size)
        and x.shape[-2] % (1 << (levels - 1)) == 0
        and x.shape[-1] % (1 << (levels - 1)) == 0
    )

    k1, k2 = k
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mcs = []
    ssim_per_channel = None
    for i in range(levels):
        if fused_chain and i < levels - 1:
            ssim_per_channel, cs, x, y = ssimfused.fused_ssim_parts_pool(
                x, y, float(c1), float(c2), win_size, win_sigma
            )
            mcs.append(torch.relu(cs))
            continue
        ssim_per_channel, cs = _ssim_parts(x, y, data_range, win_size, win_sigma, k)
        if i < levels - 1:
            mcs.append(torch.relu(cs))
            x = _avg_pool2(x)
            y = _avg_pool2(y)

    ssim_per_channel = torch.relu(ssim_per_channel)
    stacked = torch.stack(mcs + [ssim_per_channel], dim=0)  # (levels, B, C)
    val = torch.prod(stacked ** weights.view(-1, 1, 1), dim=0)
    return val.mean() if size_average else val.mean(1)
