"""Fused SSIM statistics, forward and analytic backward, for the
single-scale level and the MS-SSIM chain (counterpart:
pssr2_tpu/ops/pallas/ssimfused.py: ``_fused_l0_fn`` 434 /
``fused_level0_parts`` 550, ``_fused_pool_fn`` 570 /
``fused_ssim_parts_pool`` 663, ``_fused_fn`` 680 / ``fused_ssim_parts``
756, ``auto_ok`` 768, ``ssim_parts`` 789).

Three ``torch.autograd.Function`` s over ``csrc/ssimfused.cu`` for CUDA
tensors:

- :func:`fused_ssim_parts`: the per-image (ssim, cs) means (row 5 of the
  port's kernel table); the last MS-SSIM level and single-scale SSIM.
- :func:`fused_ssim_parts_pool`: the same plus the 2x2 pooled x and y that
  feed the next level (row 4), for the middle MS-SSIM levels.
- :func:`fused_level0_parts`: MS-SSIM level 0 of the mixed loss (row 3):
  the inputs divided by ``divisor``, their (ssim, cs) means, the
  Gaussian-windowed L1 mean and the pooled x and y.

Each forward is one launch and writes only the sums and the pooled maps;
each backward is two launches (the four VALID-grid maps, then the
transposed blur into gx and gy, with the pooled cotangents and the L1
gradient added there) and writes only the input gradients.  For a CPU
tensor each takes its plain version (:func:`reference_parts`,
:func:`reference_parts_pool`, :func:`reference_level0`), the band-matrix
form of ``ops/ssim.py`` with autograd.  A CUDA tensor never falls back to
it.  f32 only, no TF32.
"""

import ctypes
import functools

import torch

from . import cuda_build
from .ssim import _avg_pool2, _blur, _blur_same, _gaussian_window, _moments_to_ssim

# Launches of the CUDA kernels in this process (the plain versions do not
# count), per kernel: each forward adds 1 per call, each backward 2 (its
# two launches).  Row 5 (single scale), row 4 (pool level), row 3 (level 0).
fwd_launches = 0
bwd_launches = 0
pool_fwd_launches = 0
pool_bwd_launches = 0
l0_fwd_launches = 0
l0_bwd_launches = 0

# The largest window the kernels take (csrc/ssimfused.cu: MAX_WIN); the
# shared-memory tile grows with it, to 71 KB a block at 31 taps.
MAX_WIN = 31
# Agreement of the kernels with the plain versions on the same inputs:
# bounds on max |error| of the per-image means ("s", "cs", "l1"), of the
# pooled maps as a fraction of their largest magnitude ("pool"), and of
# gx, gy as a fraction of max |ref| ("g").  Only the order of the f32 sums
# differs (K-tap blurs against band products, atomics across blocks for
# the means, the L1 sum by per-pixel edge weights against the blurred
# map, the pool's 4-term sum); the variance terms and the divisions by
# terms near c2 amplify that order's rounding in the maps and their
# gradients.
TOLERANCE = {"s": 2e-5, "cs": 2e-5, "l1": 2e-6, "pool": 1e-6, "g": 1e-3}
_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def auto_ok(x, win_size: int) -> bool:
    """Whether the kernels take ``x``'s maps (the JAX gate of the same
    name, for this card): f32, an odd window, and an image at least the
    window in each dimension.  Other inputs take the band-matrix path of
    ``ops/ssim.py`` on any device, as the JAX package's do.  A window above
    :data:`MAX_WIN` passes the gate and the kernel refuses it."""
    return x.dtype == torch.float32 and win_size % 2 == 1 and min(x.shape[-2:]) >= win_size


def reference_parts(x, y, c1, c2, win_size, win_sigma):
    """(ssim, cs) means per image and channel, (B, C) each, of NCHW f32
    ``x``, ``y``: the stacked band-matrix blur and ``_moments_to_ssim``
    (any device, differentiable)."""
    stacked = torch.cat([x, y, x * x, y * y, x * y], dim=0)
    blurred = _blur(stacked, win_size, win_sigma)
    mu1, mu2, xx_b, yy_b, xy_b = torch.chunk(blurred, 5, dim=0)
    return _moments_to_ssim(mu1, mu2, xx_b, yy_b, xy_b, float(c1), float(c2))


def reference_parts_pool(x, y, c1, c2, win_size, win_sigma):
    """:func:`reference_parts` and the 2x2 pooled ``x``, ``y``
    (``_avg_pool2``)."""
    s, cs = reference_parts(x, y, c1, c2, win_size, win_sigma)
    return s, cs, _avg_pool2(x), _avg_pool2(y)


def reference_level0(x, y, c1, c2, win_size, win_sigma, divisor=1.0):
    """Level 0 of the mixed loss, plainly: ``x / divisor`` and ``y /
    divisor`` (exact f32 divides), their :func:`reference_parts`, the
    Gaussian-windowed L1 mean per image and channel (zero pad, then the
    VALID blur, util.SSIMLoss._l1_windowed) and the pooled maps."""
    if divisor != 1.0:
        d = torch.tensor(float(divisor), dtype=x.dtype, device=x.device)  # a true divide, not a reciprocal
        x, y = x / d, y / d
    s, cs = reference_parts(x, y, c1, c2, win_size, win_sigma)
    l1 = _blur_same(torch.abs(x - y), win_size, win_sigma).mean(dim=(-2, -1))
    return s, cs, l1, _avg_pool2(x), _avg_pool2(y)


@functools.cache
def _fns():
    lib = cuda_build.load("ssimfused")
    fwd, bwd = lib.ssim_fwd, lib.ssim_bwd
    fwd.argtypes = [_VOID_P, _VOID_P, _VOID_P, _INT] + [_FLOAT] * 3 + [_VOID_P] * 5 + [_INT] * 3 + [_VOID_P]
    bwd.argtypes = [_VOID_P] * 8 + [_INT] + [_FLOAT] * 4 + [_VOID_P] * 3 + [_INT] * 3 + [_VOID_P]
    fwd.restype = bwd.restype = _INT
    return fwd, bwd


@functools.lru_cache(maxsize=16)
def _taps(win_size, win_sigma):
    """The window taps as a C array (read only by the launch functions)."""
    g = _gaussian_window(win_size, win_sigma)
    return (ctypes.c_float * win_size)(*g.tolist())


def _check(x, y, win_size, pool=False):
    if x.device.type != "cuda":
        raise ValueError(f"the SSIM kernels take CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.float32 or y.dtype != torch.float32:
        raise TypeError(f"the SSIM kernels take float32 maps, got {x.dtype} and {y.dtype}")
    if x.shape != y.shape or x.dim() != 4 or y.device != x.device:
        raise ValueError(f"the SSIM kernels take two NCHW tensors of one shape, got {x.shape} and {y.shape}")
    if win_size % 2 == 0 or not 1 <= win_size <= MAX_WIN:
        raise ValueError(f"the SSIM kernels take an odd win_size of at most MAX_WIN={MAX_WIN}, got {win_size}")
    if min(x.shape[-2:]) < win_size:
        raise ValueError(f"image {tuple(x.shape[-2:])} is smaller than the window ({win_size})")
    if pool and (x.shape[-2] % 2 or x.shape[-1] % 2):
        raise ValueError(f"the pooling SSIM kernels take even H and W, got {tuple(x.shape[-2:])}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch_fwd(xs, ys, c1, c2, win_size, win_sigma, divisor=1.0, l1=False, pool=False):
    """One forward launch on (N, H, W) f32 CUDA maps: the per-image (ssim,
    cs) means, and the L1 mean (or None) and the pooled maps (or None)."""
    n, h, w = xs.shape
    sums = torch.zeros((3 if l1 else 2, n), dtype=torch.float32, device=xs.device)
    xp = yp = None
    if pool:
        xp = torch.empty((n, h // 2, w // 2), dtype=torch.float32, device=xs.device)
        yp = torch.empty_like(xp)
    fwd, _ = _fns()
    with torch.cuda.device(xs.device):
        err = fwd(
            xs.data_ptr(), ys.data_ptr(), _taps(win_size, win_sigma), win_size, c1, c2, divisor,
            sums[0].data_ptr(), sums[1].data_ptr(), sums[2].data_ptr() if l1 else None, _ptr(xp), _ptr(yp),
            n, h, w, _stream(xs.device),
        )
    if err != 0:
        raise RuntimeError(f"ssim_fwd launch failed with CUDA error {err}")
    inv_n = 1.0 / ((h - win_size + 1) * (w - win_size + 1))
    return sums[0] * inv_n, sums[1] * inv_n, sums[2] / (h * w) if l1 else None, xp, yp


def _launch_bwd(xs, ys, g_s, g_cs, c1, c2, win_size, win_sigma, divisor=1.0, g_l1=None, gxp=None, gyp=None):
    """(gx, gy) of (N, H, W) f32 CUDA maps, given the cotangents (N,) of
    the means and, where given, of the L1 mean and of the pooled maps."""
    n, h, w = xs.shape
    hp, wp = h - win_size + 1, w - win_size + 1

    def vec(g):
        return torch.zeros(n, dtype=torch.float32, device=xs.device) if g is None else g.reshape(n).float().contiguous()

    g_s, g_cs = vec(g_s), vec(g_cs)
    if g_l1 is not None:
        g_l1 = vec(g_l1)
    if (gxp is None) != (gyp is None):  # one pooled map unused downstream
        gxp, gyp = (torch.zeros((n, h // 2, w // 2), dtype=torch.float32, device=xs.device) if g is None else g
                    for g in (gxp, gyp))
    if gxp is not None:
        gxp = gxp.reshape(n, h // 2, w // 2).float().contiguous()
        gyp = gyp.reshape(n, h // 2, w // 2).float().contiguous()
    maps = torch.empty((4, n, hp, wp), dtype=torch.float32, device=xs.device)
    gx = torch.empty_like(xs)
    gy = torch.empty_like(ys)
    _, bwd = _fns()
    with torch.cuda.device(xs.device):
        err = bwd(
            xs.data_ptr(), ys.data_ptr(), g_s.data_ptr(), g_cs.data_ptr(), _ptr(g_l1), _ptr(gxp), _ptr(gyp),
            _taps(win_size, win_sigma), win_size, c1, c2, divisor, 1.0 / (hp * wp),
            maps.data_ptr(), gx.data_ptr(), gy.data_ptr(), n, h, w, _stream(xs.device),
        )
    if err != 0:
        raise RuntimeError(f"ssim_bwd launch failed with CUDA error {err}")
    return gx, gy


def _flat(x, y):
    b, c, h, w = x.shape
    return x.reshape(b * c, h, w).contiguous(), y.reshape(b * c, h, w).contiguous()


class _FusedSSIM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, c1, c2, win_size, win_sigma):
        global fwd_launches
        xs, ys = _flat(x, y)
        s, cs, _, _, _ = _launch_fwd(xs, ys, c1, c2, win_size, win_sigma)
        fwd_launches += 1
        ctx.save_for_backward(xs, ys)
        ctx.args = (c1, c2, win_size, win_sigma)
        ctx.shape = x.shape
        return s.view(x.shape[:2]), cs.view(x.shape[:2])

    @staticmethod
    def backward(ctx, g_s, g_cs):
        global bwd_launches
        xs, ys = ctx.saved_tensors
        gx, gy = _launch_bwd(xs, ys, g_s, g_cs, *ctx.args)
        bwd_launches += 2
        return gx.view(ctx.shape), gy.view(ctx.shape), None, None, None, None


class _FusedPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, c1, c2, win_size, win_sigma):
        global pool_fwd_launches
        ctx.set_materialize_grads(False)
        b, c, h, w = x.shape
        xs, ys = _flat(x, y)
        s, cs, _, xp, yp = _launch_fwd(xs, ys, c1, c2, win_size, win_sigma, pool=True)
        pool_fwd_launches += 1
        ctx.save_for_backward(xs, ys)
        ctx.args = (c1, c2, win_size, win_sigma)
        ctx.shape = x.shape
        half = (b, c, h // 2, w // 2)
        return s.view(b, c), cs.view(b, c), xp.view(half), yp.view(half)

    @staticmethod
    def backward(ctx, g_s, g_cs, g_xp, g_yp):
        global pool_bwd_launches
        xs, ys = ctx.saved_tensors
        gx, gy = _launch_bwd(xs, ys, g_s, g_cs, *ctx.args, gxp=g_xp, gyp=g_yp)
        pool_bwd_launches += 2
        return gx.view(ctx.shape), gy.view(ctx.shape), None, None, None, None


class _FusedLevel0(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, y, c1, c2, win_size, win_sigma, divisor):
        global l0_fwd_launches
        ctx.set_materialize_grads(False)
        b, c, h, w = x.shape
        xs, ys = _flat(x, y)
        s, cs, l1, xp, yp = _launch_fwd(xs, ys, c1, c2, win_size, win_sigma, divisor, l1=True, pool=True)
        l0_fwd_launches += 1
        ctx.save_for_backward(xs, ys)
        ctx.args = (c1, c2, win_size, win_sigma, divisor)
        ctx.shape = x.shape
        half = (b, c, h // 2, w // 2)
        return s.view(b, c), cs.view(b, c), l1.view(b, c), xp.view(half), yp.view(half)

    @staticmethod
    def backward(ctx, g_s, g_cs, g_l1, g_xp, g_yp):
        global l0_bwd_launches
        xs, ys = ctx.saved_tensors
        if g_l1 is None:
            g_l1 = torch.zeros(xs.shape[0], dtype=torch.float32, device=xs.device)
        gx, gy = _launch_bwd(xs, ys, g_s, g_cs, *ctx.args, g_l1=g_l1, gxp=g_xp, gyp=g_yp)
        l0_bwd_launches += 2
        return gx.view(ctx.shape), gy.view(ctx.shape), None, None, None, None, None


def fused_ssim_parts(x, y, c1, c2, win_size, win_sigma):
    """(ssim, cs) means per image and channel, (B, C) each, of NCHW f32
    ``x``, ``y`` (VALID windows, pytorch_msssim semantics): by the CUDA
    kernels for a CUDA tensor, by :func:`reference_parts` for a CPU one."""
    if x.device.type == "cpu":
        return reference_parts(x, y, c1, c2, win_size, win_sigma)
    _check(x, y, win_size)
    return _FusedSSIM.apply(x, y, float(c1), float(c2), int(win_size), float(win_sigma))


def fused_ssim_parts_pool(x, y, c1, c2, win_size, win_sigma):
    """One middle MS-SSIM level: (ssim, cs, x_pooled, y_pooled) for NCHW
    f32 batches with even H and W, the pool in the kernel (torch pool
    semantics on even dims, ops/ssim._avg_pool2)."""
    if x.device.type == "cpu":
        return reference_parts_pool(x, y, c1, c2, win_size, win_sigma)
    _check(x, y, win_size, pool=True)
    return _FusedPool.apply(x, y, float(c1), float(c2), int(win_size), float(win_sigma))


def fused_level0_parts(x, y, c1, c2, win_size, win_sigma, divisor=1.0):
    """Level 0 of the mixed MS-SSIM + L1 loss for NCHW f32 batches with
    even H and W: (ssim, cs, l1, x_pooled, y_pooled), all computed on ``x /
    divisor`` and ``y / divisor`` (exact f32 divides) without forming the
    divided tensors in device memory."""
    if x.device.type == "cpu":
        return reference_level0(x, y, c1, c2, win_size, win_sigma, divisor)
    _check(x, y, win_size, pool=True)
    return _FusedLevel0.apply(x, y, float(c1), float(c2), int(win_size), float(win_sigma), float(divisor))


# the entry ops/ssim.py calls (pssr2_tpu/ops/pallas/ssimfused.py:789)
ssim_parts = fused_ssim_parts
