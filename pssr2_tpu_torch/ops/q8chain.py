"""One int8 conv layer of the W8A8 serving forward: int8 NHWC activations
and int8 weights, exact int32 sums, one f32 per-channel affine (alpha,
beta), then either ReLU and the requantization to the next layer's int8
scale (mid-chain) or the glue dtype out (f32 or bf16).

Counterpart: pssr2_tpu/ops/pallas/q8chain.py (``q8_conv_layer`` 122 with
its kernel ``_q8_layer_kernel`` 82, and the oracle ``reference_q8_layer``
163) and the per-conv int8 sites of pssr2_tpu/quant.py (``int8_conv`` and
``_qconv``, 240-277), which XLA ran on the TPU: PyTorch has no int8
convolution on CUDA, so every int8 conv of the port's executors is this
kernel, ``csrc/q8chain.cu``, built by ``ops/cuda_build.py``.  The TPU
kernel ran in the convchain (N, H/P, C, P*W) layout; here activations stay
NHWC and the conv may be 3x3 or 1x1, with any Cin.

For a CUDA tensor :func:`q8_conv_layer` launches the kernel; for a CPU
tensor it takes :func:`reference_q8_layer`.  A CUDA tensor never falls
back to the plain version.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

# Launches of the CUDA kernel in this process (the plain version does not count).
launches = 0

# Tolerance: none.  The kernel's outputs equal the plain version's bit for
# bit, int8 (mid-chain) and glue (f32, bf16) alike: the int32 sums are exact
# on both sides, and the epilogue takes the same f32 multiply and add,
# each rounded (no fused multiply-add), then the same rounding to the
# output type.
KC = 32  # the kernel's k-tile of input channels

_MODE = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
_VOID_P, _INT = ctypes.c_void_p, ctypes.c_int


def reference_q8_layer(x8, w8, affine, *, last=False, out_dtype=torch.bfloat16):
    """Plain PyTorch version of the kernel (any device): NHWC int8 ``x8``,
    (Cout, Cin, K, K) int8 ``w8``, (2, Cout) f32 ``affine``.  The conv runs
    in float64, exact (a sum of at most 9 * Cin products of at most 127^2),
    rounded to the integer it is whatever algorithm the convolution takes;
    then ``z = float(acc) * alpha + beta`` in f32, and either ReLU, round
    half to even and clip to [-127, 127] as int8 (``last=False``) or ``z``
    in ``out_dtype``."""
    k = w8.shape[-1]
    acc = torch.round(F.conv2d(x8.permute(0, 3, 1, 2).double(), w8.double(), padding=k // 2)).permute(0, 2, 3, 1)
    z = acc.float() * affine[0] + affine[1]
    if last:
        return z.to(out_dtype)
    return torch.clamp(torch.round(torch.clamp(z, min=0.0)), -127.0, 127.0).to(torch.int8)


def kernel_weight(w8):
    """(Cout, Cin, K, K) int8 -> the kernel's (K*K, ceil(Cin/32)*8, Cout)
    int32 words of 4 input channels (byte b of a word: channel 4*word + b),
    zero-padded to the k-tile."""
    cout, cin, k, _ = w8.shape
    cinp = -(-cin // KC) * KC
    wt = w8.permute(2, 3, 0, 1).reshape(k * k, cout, cin)
    wt = F.pad(wt, (0, cinp - cin)).contiguous()
    return wt.view(torch.int32).transpose(1, 2).contiguous()


@functools.cache
def _fn():
    fn = cuda_build.load("q8chain").q8_conv_layer
    fn.argtypes = [_VOID_P] * 4 + [_INT] * 7 + [_VOID_P]
    fn.restype = _INT
    return fn


def _check(x8, w8, affine, wk):
    if x8.device.type != "cuda":
        raise ValueError(f"q8_conv_layer takes CPU or CUDA tensors, got {x8.device}")
    if x8.dtype != torch.int8 or w8.dtype != torch.int8 or affine.dtype != torch.float32:
        raise TypeError(f"q8_conv_layer takes int8 x8 and w8 and a float32 affine, got {x8.dtype}, {w8.dtype}, "
                        f"{affine.dtype}")
    if x8.dim() != 4 or not x8.is_contiguous():
        raise ValueError("q8_conv_layer takes a contiguous (N, H, W, Cin) int8 tensor")
    cout, cin, k = w8.shape[0], x8.shape[3], w8.shape[-1]
    if tuple(w8.shape) != (cout, cin, k, k) or k not in (1, 3):
        raise ValueError(f"w8 {tuple(w8.shape)} does not fit x8 {tuple(x8.shape)}: expected ({cout}, {cin}, 3|1, 3|1)")
    if tuple(affine.shape) != (2, cout) or not affine.is_contiguous():
        raise ValueError(f"affine must be a contiguous (2, {cout}) tensor, got {tuple(affine.shape)}")
    if wk is not None and (tuple(wk.shape) != (k * k, -(-cin // KC) * KC // 4, cout) or wk.dtype != torch.int32
                           or not wk.is_contiguous()):
        raise ValueError(f"wk {tuple(wk.shape)} is not kernel_weight(w8)")
    if any(t.device != x8.device for t in (w8, affine) + ((wk,) if wk is not None else ())):
        raise ValueError("q8_conv_layer: all inputs must be on x8's device")


def _launch(x8, w8, affine, out_dtype, wk=None):
    global launches
    _check(x8, w8, affine, wk)
    n, h, w, cin = x8.shape
    cout, k = w8.shape[0], w8.shape[-1]
    wk = kernel_weight(w8) if wk is None else wk
    y = torch.empty((n, h, w, cout), dtype=out_dtype, device=x8.device)
    with torch.cuda.device(x8.device):
        err = _fn()(x8.data_ptr(), wk.data_ptr(), affine.data_ptr(), y.data_ptr(), n, h, w, cin, cout, k,
                    _MODE[out_dtype], torch.cuda.current_stream(x8.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"q8_conv_layer launch failed with CUDA error {err}")
    launches += 1
    return y


def q8_conv_layer(x8, w8, affine, *, last=False, out_dtype=torch.bfloat16, wk=None):
    """One int8 layer: :func:`reference_q8_layer`'s function, by the CUDA
    kernel when ``x8`` lies on a CUDA device.  ``last=False`` gives the
    mid-chain int8 requantization (1/sx_next already folded into
    ``affine``), ``last=True`` the glue dtype ``out_dtype``; ``wk`` is
    :func:`kernel_weight` of ``w8`` where the caller keeps it."""
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q8_conv_layer emits float32 or bfloat16, got {out_dtype}")
    if x8.device.type == "cpu":
        return reference_q8_layer(x8, w8, affine, last=last, out_dtype=out_dtype)
    return _launch(x8, w8, affine, out_dtype if last else torch.int8, wk)

