"""One ResBlock conv layer as a single fused pass: the previous layer's
eval BatchNorm + ReLU as a prologue, a 3x3 SAME conv, the bias, and f32
per-channel (sum, sum of squares) of the output.

Counterpart: pssr2_tpu/ops/pallas/convchain.py (``fused_conv_layer`` at
516, kernel ``_layer_kernel`` at 185, oracle ``reference_layer`` at 542).
The TPU kernel runs in a (N, H, C, W) layout; here activations stay NHWC
and the kernel is ``csrc/convchain.cu``, built by ``ops/cuda_build.py``.

:func:`fused_conv_layer` launches that kernel for a CUDA tensor and takes
:func:`reference_layer`, the plain PyTorch version of the same function,
for a CPU tensor.  A CUDA tensor never falls back to the plain version.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

# Launches of the CUDA kernel in this process (the plain version does not count).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Agreement of the kernel with reference_layer on the same inputs: bounds on
# max |dy|, |ds1|, |ds2| as fractions of max |y|, of sum |y| and of sum y^2
# (the largest channel's).  In f32 only the order of summation differs (the
# 9*Cin products, and the atomics across blocks for the sums).  In bf16 one
# f32 ulp of difference can move an output's rounding by one bf16 ulp, so y
# gets 2 ulps of its magnitude, s1 one ulp per element and s2 two.
TOLERANCE = {torch.float32: (1e-4, 1e-4, 1e-4), torch.bfloat16: (1 / 64, 1 / 256, 1 / 128)}
_VOID_P, _INT = ctypes.c_void_p, ctypes.c_int


def reference_layer(x, weight, bias, ab=None):
    """Plain PyTorch version of the kernel (any device).

    x: (N, H, W, Cin) float32 or bfloat16; weight: (Cout, Cin, 3, 3);
    bias: (Cout,); ab: None, or (2, Cin) f32 prologue coefficients.
    Returns y (N, H, W, Cout) in x's dtype and f32 (Cout,) sums s1, s2.

    Rounding order of the JAX reference_layer: the prologue is an f32
    affine + ReLU rounded once to x's dtype; the conv accumulates in f32
    and rounds to x's dtype; the bias is added in x's dtype; the sums are
    taken in f32 from the rounded y.
    """
    dt = x.dtype
    h = x
    if ab is not None:
        h = torch.relu(x.float() * ab[0] + ab[1]).to(dt)
    out = F.conv2d(h.permute(0, 3, 1, 2).float(), weight.to(dt).float(), padding=1)
    y = out.permute(0, 2, 3, 1).to(dt) + bias.to(dt)
    yf = y.float()
    return y.contiguous(), yf.sum(dim=(0, 1, 2)), (yf * yf).sum(dim=(0, 1, 2))


def errors(got, ref):
    """Errors of ``got`` = (y, s1, s2) against ``ref`` under :data:`TOLERANCE`:
    {"y": (max abs error, relative error, bound on the abs error), "s1": ...}.
    The relative error is the abs error over max |y|, sum |y| or sum y^2."""
    y_tol, s1_tol, s2_tol = TOLERANCE[ref[0].dtype]
    yr = ref[0].float()
    scales = {
        "y": (yr.abs().max().item(), y_tol),
        "s1": (yr.abs().sum(dim=(0, 1, 2)).max().item(), s1_tol),
        "s2": ((yr * yr).sum(dim=(0, 1, 2)).max().item(), s2_tol),
    }
    out = {}
    for name, g, r in zip(("y", "s1", "s2"), got, ref):
        err = (g.float() - r.float()).abs().max().item()
        scale, tol = scales[name]
        out[name] = (err, err / scale if scale else 0.0, tol * scale)
    return out


def _lib():
    lib = cuda_build.load("convchain")
    fn = lib.convchain_fwd
    fn.argtypes = [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P]
    fn.restype = _INT
    return fn


def kernel_weight(weight, dtype):
    """(Cout, Cin, 3, 3) -> the kernel's (9, Cin, Cout) [tap][cin][cout]
    layout, contiguous, in the activation dtype."""
    cout, cin = weight.shape[:2]
    return weight.to(dtype).permute(2, 3, 1, 0).reshape(9, cin, cout).contiguous()


def fused_conv_layer(x, weight, bias, ab=None):
    """y, s1, s2 of :func:`reference_layer`, by the CUDA kernel when ``x``
    lies on a CUDA device.  ``ab=None`` skips the prologue (chain entry).
    Forward only: raises when grad mode is on and an input requires grad."""
    if x.device.type == "cpu":
        return reference_layer(x, weight, bias, ab)
    global launches
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, weight, bias, ab)
    ):
        raise RuntimeError("fused_conv_layer is forward only; run it under torch.no_grad()")
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_layer takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_conv_layer takes float32 or bfloat16 activations, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_conv_layer takes a contiguous (N, H, W, Cin) tensor")
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3) or tuple(bias.shape) != (cout,):
        raise ValueError(
            f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} do not fit "
            f"x {tuple(x.shape)}: expected ({cout}, {cin}, 3, 3) and ({cout},)"
        )
    if ab is not None and (tuple(ab.shape) != (2, cin) or ab.dtype != torch.float32):
        raise ValueError(f"ab must be float32 of shape (2, {cin}), got {ab.dtype} {tuple(ab.shape)}")
    tensors = [weight, bias] + ([ab] if ab is not None else [])
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_conv_layer: all inputs must be on x's device")

    wk = kernel_weight(weight, x.dtype)
    bk = bias.to(x.dtype).contiguous()
    abk = ab.contiguous() if ab is not None else None
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    s1 = torch.zeros(cout, dtype=torch.float32, device=x.device)
    s2 = torch.zeros(cout, dtype=torch.float32, device=x.device)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(), abk.data_ptr() if abk is not None else None,
            y.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            n, h, w, cin, cout, _DTYPE_CODE[x.dtype], int(abk is not None), stream,
        )
    if err != 0:
        raise RuntimeError(f"convchain_fwd launch failed with CUDA error {err}")
    launches += 1
    return y, s1, s2
