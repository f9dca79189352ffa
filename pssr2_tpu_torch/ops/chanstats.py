"""Per-channel dual sums over a (rows, C) view: ``dual_sums(x, y) -> (2, C)
f32 = [sum(x), sum(x * y)]`` in one pass over the operands.  Train-mode
BatchNorm needs exactly this pair twice a layer (forward ``sum x, sum
x^2``; backward ``sum gy, sum gy * x``), and a per-channel affine's
backward ``sum gy, sum gy * h``.

Counterpart: pssr2_tpu/ops/pallas/chanstats.py (``dual_sums`` 63 with its
kernel ``_dual_sums_kernel`` 45, and the plain ``_dual_sums_jnp`` 56).
Here the kernel is ``csrc/chanstats.cu``, built by ``ops/cuda_build.py``.
For a CUDA tensor :func:`dual_sums` launches it; for a CPU tensor it takes
:func:`dual_sums_plain`.  A CUDA tensor never falls back to the plain
version.
"""

import ctypes
import functools

import torch

from . import cuda_build

# Launches of the CUDA kernel in this process (the plain version does not count).
launches = 0

# Agreement of the kernel with dual_sums_plain on the same inputs: max
# |error| of a channel's sum against this fraction of its sum of
# magnitudes (sum |x|, sum |x y|).  Only the order of the f32 sums differs
# (per thread, across a block's threads, then atomics across blocks), and
# products of bf16 values are exact in f32.
TOLERANCE = 1e-5

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VOID_P, _INT, _LONG = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def dual_sums_plain(x, y):
    """Plain PyTorch version of the kernel (any device): f32 [sum(x, 0),
    sum(x * y, 0)] of (rows, C) operands."""
    xf = x.float()
    return torch.stack([xf.sum(0), (xf * y.float()).sum(0)])


def errors(got, x, y):
    """(max abs error against the plain version, the largest ratio of a
    channel's error to its bound TOLERANCE * sum of magnitudes)."""
    ref = dual_sums_plain(x, y)
    mags = dual_sums_plain(x.abs(), y.abs())
    err = (got - ref).abs()
    return err.max().item(), (err / (TOLERANCE * mags).clamp_min(1e-30)).max().item()


@functools.cache
def _fn():
    fn = cuda_build.load("chanstats").chanstats_dual_sums
    fn.argtypes = [_VOID_P, _VOID_P, _VOID_P, _LONG, _INT, _INT, _VOID_P]
    fn.restype = _INT
    return fn


def _check(x, y):
    if x.device.type != "cuda":
        raise ValueError(f"dual_sums takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE or y.dtype != x.dtype:
        raise TypeError(f"dual_sums takes float32 or bfloat16 operands of one dtype, got {x.dtype}, {y.dtype}")
    if x.dim() != 2 or x.shape != y.shape or not x.is_contiguous() or not y.is_contiguous():
        raise ValueError(f"dual_sums takes two contiguous (rows, C) operands, got {tuple(x.shape)}, {tuple(y.shape)}")
    if y.device != x.device:
        raise ValueError("dual_sums: x and y must be on one device")


def _launch(x, y):
    global launches
    _check(x, y)
    rows, c = x.shape
    out = torch.zeros((2, c), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _fn()(x.data_ptr(), y.data_ptr(), out.data_ptr(), rows, c, _DTYPE_CODE[x.dtype],
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"chanstats_dual_sums launch failed with CUDA error {err}")
    launches += 1
    return out


def dual_sums(x, y):
    """[sum(x, 0), sum(x * y, 0)] as (2, C) float32 for (rows, C) operands
    of one dtype, by the CUDA kernel when they lie on a CUDA device."""
    if x.device.type == "cpu":
        return dual_sums_plain(x, y)
    return _launch(x, y)


def channel_sums(x, y):
    """:func:`dual_sums` over every axis but the last of two channels-last
    tensors of one shape."""
    c = x.shape[-1]
    return dual_sums(x.contiguous().view(-1, c), y.contiguous().view(-1, c))
