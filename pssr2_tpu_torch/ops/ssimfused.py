"""Fused single-scale SSIM statistics, forward and analytic backward
(counterpart: pssr2_tpu/ops/pallas/ssimfused.py: ``_fused_fn`` 680,
``fused_ssim_parts`` 756, ``ssim_parts`` 789; kernels ``_fwd_kernel`` 239
and ``_bwd_kernel`` 254).

:func:`fused_ssim_parts` is a ``torch.autograd.Function`` over
``csrc/ssimfused.cu`` for a CUDA tensor: the forward forms the five
moment maps, blurs them, combines them into the SSIM and cs maps and sums
those per image, writing only two numbers per image; the backward
recomputes the moments and writes only the input gradients (two launches,
with four VALID-grid maps between them).  For a CPU tensor it takes
:func:`reference_parts`, the band-matrix form of ``ops/ssim.py`` with
autograd, the plain version of the same function.  A CUDA tensor never
falls back to it.  f32 only, no TF32.
"""

import ctypes
import functools

import torch

from . import cuda_build
from .ssim import _blur, _gaussian_window, _moments_to_ssim

# Launches of the CUDA kernels in this process (the plain version does not
# count): the forward adds 1 per call, the backward 2 (its two launches).
fwd_launches = 0
bwd_launches = 0

# Window taps the kernel is built for (the loss's default win_size).
WIN = 11
# Agreement of the kernels with reference_parts on the same inputs: bounds
# on max |error| of the per-image (ssim, cs) means, and of gx, gy as a
# fraction of max |ref|.  Only the order of the f32 sums differs (11-tap
# blurs against band products, atomics across blocks for the means); the
# variance terms and the divisions by terms near c2 amplify that order's
# rounding in the maps and their gradients.
TOLERANCE = {"s": 2e-5, "cs": 2e-5, "g": 1e-3}
_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reference_parts(x, y, c1, c2, win_size, win_sigma):
    """(ssim, cs) means per image and channel, (B, C) each, of NCHW f32
    ``x``, ``y``: the stacked band-matrix blur and ``_moments_to_ssim``
    (any device, differentiable)."""
    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=0)
    blurred = _blur(stacked, win_size, win_sigma)
    mu1, mu2, xx_b, yy_b, xy_b = torch.chunk(blurred, 5, dim=0)
    return _moments_to_ssim(mu1, mu2, xx_b, yy_b, xy_b, float(c1), float(c2))


@functools.cache
def _fns():
    lib = cuda_build.load("ssimfused")
    fwd, bwd = lib.ssim_fwd, lib.ssim_bwd
    fwd.argtypes = [_VOID_P, _VOID_P, _VOID_P, _INT, _FLOAT, _FLOAT, _VOID_P, _VOID_P] + [_INT] * 3 + [_VOID_P]
    bwd.argtypes = [_VOID_P] * 5 + [_INT, _FLOAT, _FLOAT, _FLOAT] + [_VOID_P] * 3 + [_INT] * 3 + [_VOID_P]
    fwd.restype = bwd.restype = _INT
    return fwd, bwd


def _taps(win_size, win_sigma):
    g = _gaussian_window(win_size, win_sigma)
    return (ctypes.c_float * win_size)(*g.tolist())


def _check(x, y, win_size):
    if x.device.type != "cuda":
        raise ValueError(f"fused_ssim_parts takes CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"fused_ssim_parts takes float32 maps, got {x.dtype} and {y.dtype}")
    if x.shape != y.shape or x.dim() != 4 or y.device != x.device:
        raise ValueError(f"fused_ssim_parts takes two NCHW tensors of one shape, got {x.shape} and {y.shape}")
    if win_size != WIN:
        raise ValueError(f"the SSIM kernel takes win_size={WIN}, got {win_size}")
    if min(x.shape[-2:]) < win_size:
        raise ValueError(f"image {tuple(x.shape[-2:])} is smaller than the window ({win_size})")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(xs, ys, c1, c2, win_size, win_sigma):
    """Per-image (ssim, cs) means of (N, H, W) f32 CUDA maps."""
    global fwd_launches
    n, h, w = xs.shape
    s = torch.zeros(n, dtype=torch.float32, device=xs.device)
    cs = torch.zeros_like(s)
    fwd, _ = _fns()
    with torch.cuda.device(xs.device):
        err = fwd(
            xs.data_ptr(), ys.data_ptr(), _taps(win_size, win_sigma), win_size, c1, c2,
            s.data_ptr(), cs.data_ptr(), n, h, w, _stream(xs.device),
        )
    if err != 0:
        raise RuntimeError(f"ssim_fwd launch failed with CUDA error {err}")
    fwd_launches += 1
    inv_n = 1.0 / ((h - win_size + 1) * (w - win_size + 1))
    return s * inv_n, cs * inv_n


def _launch_bwd(xs, ys, g_s, g_cs, c1, c2, win_size, win_sigma):
    """(gx, gy) of (N, H, W) f32 CUDA maps, given the cotangents (N,) of
    the means."""
    global bwd_launches
    n, h, w = xs.shape
    hp, wp = h - win_size + 1, w - win_size + 1
    g_s = g_s.reshape(n).float().contiguous()
    g_cs = g_cs.reshape(n).float().contiguous()
    maps = torch.empty((4, n, hp, wp), dtype=torch.float32, device=xs.device)
    gx = torch.empty_like(xs)
    gy = torch.empty_like(ys)
    _, bwd = _fns()
    with torch.cuda.device(xs.device):
        err = bwd(
            xs.data_ptr(), ys.data_ptr(), g_s.data_ptr(), g_cs.data_ptr(), _taps(win_size, win_sigma),
            win_size, c1, c2, 1.0 / (hp * wp), maps.data_ptr(), gx.data_ptr(), gy.data_ptr(),
            n, h, w, _stream(xs.device),
        )
    if err != 0:
        raise RuntimeError(f"ssim_bwd launch failed with CUDA error {err}")
    bwd_launches += 2
    return gx, gy


class _FusedSSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, c1, c2, win_size, win_sigma):
        b, c, h, w = x.shape
        xs = x.reshape(b * c, h, w).contiguous()
        ys = y.reshape(b * c, h, w).contiguous()
        s, cs = _launch_fwd(xs, ys, c1, c2, win_size, win_sigma)
        ctx.save_for_backward(xs, ys)
        ctx.args = (c1, c2, win_size, win_sigma)
        ctx.shape = x.shape
        return s.view(b, c), cs.view(b, c)

    @staticmethod
    def backward(ctx, g_s, g_cs):
        xs, ys = ctx.saved_tensors
        gx, gy = _launch_bwd(xs, ys, g_s, g_cs, *ctx.args)
        return gx.view(ctx.shape), gy.view(ctx.shape), None, None, None, None


def fused_ssim_parts(x, y, c1, c2, win_size, win_sigma):
    """(ssim, cs) means per image and channel, (B, C) each, of NCHW f32
    ``x``, ``y`` (VALID windows, pytorch_msssim semantics): by the CUDA
    kernels for a CUDA tensor, by :func:`reference_parts` for a CPU one."""
    if x.device.type == "cpu":
        return reference_parts(x, y, c1, c2, win_size, win_sigma)
    _check(x, y, win_size)
    return _FusedSSIM.apply(x, y, float(c1), float(c2), int(win_size), float(win_sigma))


# the entry ops/ssim.py calls (pssr2_tpu/ops/pallas/ssimfused.py:789)
ssim_parts = fused_ssim_parts
