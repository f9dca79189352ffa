"""Differentiable (sigmoid-binned) soft histogram for training the learned
crappifier: values are soft-assigned to bins by differences of sigmoid
CDFs, so noise-profile histograms admit gradients (reference:
pssr/models/_blocks.py:94-112).

Counterpart: pssr2_tpu/ops/gradhist.py (``GradHist``, the XLA
formulation, and ``make_gradhist``) together with
pssr2_tpu/ops/pallas/gradhist.py (``gradhist_pallas``, kernels
``_fwd_kernel`` 33 and ``_bwd_kernel`` 53 reached through ``_run_fwd`` 76
and ``_run_bwd`` 95).  Here the kernels are ``csrc/gradhist.cu``, built
by ``ops/cuda_build.py``.

:func:`gradhist` is a ``torch.autograd.Function``: for a CUDA tensor its
forward and backward launch the kernels; for a CPU tensor they take
:func:`gradhist_plain` and :func:`gradhist_bwd_plain`.  A CUDA tensor
never falls back to the plain versions.
"""

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

# Launches of the CUDA kernels in this process (the plain versions do not
# count): one per forward and one per backward.
launches = 0
bwd_launches = 0

# Agreement of the kernels with the plain versions on the same inputs.
# Forward: each of the N terms s_{k-1} - s_k of a bin may differ by a few
# f32 ulps at 1 (the kernel's expf is accurate to 2 ulps, torch.sigmoid's
# exp to 1, and the divide and the difference round once each), so a bin
# gets N * 2^-21 absolute (0.0078 at the crappifier's N = 16384; measured far
# below, since the errors do not all share a sign), plus 2^-14 of its mass
# for the order of the f32 sum (the blocks add with atomics).  Backward:
# the same per-term error on s (1 - s) times |gdiff_k|, summed over the
# bins: sigma * sum_k |gdiff_k| * 2^-20, plus 2^-14 of max |dv|.
FWD_ULPS, BWD_ULPS, SUM_REL = 2.0**-21, 2.0**-20, 2.0**-14
_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def bin_centers(bins: int = 512, range=(-256, 256)):
    """(bins,) f32 centres, computed in float64 and rounded once, as
    ``GradHistPallas`` computes them."""
    if not range[1] > range[0]:
        raise ValueError(f"range must be increasing, got {range}")
    delta = float(range[1] - range[0]) / float(bins)
    return torch.from_numpy(float(range[0]) + delta * (np.arange(bins, dtype=np.float64) + 0.5)).float()


def _sigmoids(values, centers, sigma):
    """(B, bins, N) s_k(n) = sigmoid((v_n - c_k) * sigma), in f32."""
    return torch.sigmoid((values[:, None, :] - centers[None, :, None]) * sigma)


def gradhist_plain(values, centers, sigma):
    """Plain PyTorch version of the forward kernel (any device): the XLA
    formulation of ``GradHist.__call__`` (pssr2_tpu/ops/gradhist.py:23-32).
    values (B, N) f32, centers (bins,) f32 -> (B, bins) f32."""
    s = _sigmoids(values, centers, sigma)
    prev = torch.cat([torch.ones_like(s[:, :1]), s[:, :-1]], dim=1)
    return (prev - s).sum(dim=-1)


def _gdiff(g):
    """gdiff_k = g_{k+1} - g_k with g_bins = 0 (``_vjp_bwd``, 137-147)."""
    return torch.cat([g[:, 1:], torch.zeros_like(g[:, :1])], dim=1) - g


def gradhist_bwd_plain(values, centers, sigma, g):
    """Plain PyTorch version of the backward kernel (any device): the
    cotangent of ``values`` for the cotangent ``g`` (B, bins) of the
    histogram, ``dv_n = sigma * sum_k gdiff_k s_k(n) (1 - s_k(n))``."""
    s = _sigmoids(values, centers, sigma)
    return sigma * (s * (1.0 - s) * _gdiff(g.float())[:, :, None]).sum(dim=1)


def errors(got, ref, n):
    """Forward errors of a (B, bins) histogram over N values per row: (max
    abs error, the largest ratio of an error to its bound above)."""
    err = (got - ref).abs()
    return err.max().item(), (err / (n * FWD_ULPS + SUM_REL * ref.abs())).max().item()


def bwd_errors(got, ref, g, sigma):
    """Backward errors for the histogram cotangent ``g``: (max abs error,
    the largest ratio of an error to its bound above)."""
    row = sigma * _gdiff(g.float()).abs().sum(dim=1, keepdim=True) * BWD_ULPS
    err = (got - ref).abs()
    return err.max().item(), (err / (row + SUM_REL * ref.abs().max())).max().item()


@functools.cache
def _fwd_fn():
    fn = cuda_build.load("gradhist").gradhist_fwd
    fn.argtypes = [_VOID_P, _VOID_P, _FLOAT, _VOID_P, _INT, _INT, _INT, _VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _bwd_fn():
    fn = cuda_build.load("gradhist").gradhist_bwd
    fn.argtypes = [_VOID_P, _VOID_P, _FLOAT, _VOID_P, _VOID_P, _INT, _INT, _INT, _VOID_P]
    fn.restype = _INT
    return fn


def _check(values, centers):
    if values.device.type != "cuda":
        raise ValueError(f"gradhist takes CPU or CUDA tensors, got {values.device}")
    if values.dtype != torch.float32 or centers.dtype != torch.float32:
        raise TypeError(f"gradhist takes float32 values and centers, got {values.dtype}, {centers.dtype}")
    if values.dim() != 2 or not values.is_contiguous() or centers.dim() != 1 or not centers.is_contiguous():
        raise ValueError("gradhist takes contiguous (B, N) values and (bins,) centers")
    if centers.device != values.device:
        raise ValueError("gradhist: values and centers must be on one device")
    if 2 * 4 * centers.shape[0] > 48 * 1024:
        raise ValueError(f"gradhist: at most 6144 bins, got {centers.shape[0]}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(values, centers, sigma):
    global launches
    _check(values, centers)
    b, n = values.shape
    hist = torch.zeros((b, centers.shape[0]), dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        err = _fwd_fn()(values.data_ptr(), centers.data_ptr(), float(sigma), hist.data_ptr(), b, n,
                        centers.shape[0], _stream(values.device))
    if err != 0:
        raise RuntimeError(f"gradhist_fwd launch failed with CUDA error {err}")
    launches += 1
    return hist


def _launch_bwd(values, centers, sigma, g):
    global bwd_launches
    _check(values, centers)
    b, n = values.shape
    gdiff = _gdiff(g.float()).contiguous()
    dv = torch.empty_like(values)
    with torch.cuda.device(values.device):
        err = _bwd_fn()(values.data_ptr(), centers.data_ptr(), float(sigma), gdiff.data_ptr(), dv.data_ptr(),
                        b, n, centers.shape[0], _stream(values.device))
    if err != 0:
        raise RuntimeError(f"gradhist_bwd launch failed with CUDA error {err}")
    bwd_launches += 1
    return dv


class _GradHist(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, centers, sigma):
        ctx.save_for_backward(values, centers)
        ctx.sigma = sigma
        if values.device.type == "cpu":
            return gradhist_plain(values, centers, sigma)
        return _launch_fwd(values, centers, sigma)

    @staticmethod
    def backward(ctx, g):
        values, centers = ctx.saved_tensors
        bwd = gradhist_bwd_plain if values.device.type == "cpu" else _launch_bwd
        return bwd(values, centers, ctx.sigma, g.contiguous()), None, None


def gradhist(values, centers, sigma):
    """(B, bins) soft histogram of (B, N) f32 ``values``, by the CUDA
    kernels when they lie on a CUDA device; differentiable in ``values``."""
    return _GradHist.apply(values, centers, sigma)


class GradHist:
    """Soft histogram of per-sample values: ``GradHist()(x)`` maps (B, ...)
    to (B, bins) f32 (the JAX ``GradHist`` and ``GradHistPallas``)."""

    def __init__(self, bins: int = 512, range=(-256, 256), sigma: float = 5.0):
        self.centers = bin_centers(bins, range)
        self.sigma = float(sigma)
        self.bins = bins
        self._on = {}  # the centres copied to each device once, not every call

    def __call__(self, x):
        flat = x.reshape(x.shape[0], -1).float().contiguous()
        if flat.device not in self._on:
            self._on[flat.device] = self.centers.to(flat.device)
        return gradhist(flat, self._on[flat.device], self.sigma)


def make_gradhist(bins: int = 512, range=(-256, 256), sigma: float = 5.0):
    """The soft histogram of ``train_crappifier``: the same object on every
    device; a CUDA input always takes the kernels."""
    return GradHist(bins, range, sigma)
