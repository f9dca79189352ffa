"""One ResBlock conv layer as a single fused pass: the previous layer's
BatchNorm apply + ReLU as a prologue, a 3x3 SAME conv, the bias, and f32
per-channel (sum, sum of squares) of the output; and its VJP.

Counterpart: pssr2_tpu/ops/pallas/convchain.py (``fused_conv_layer`` at
516 with its custom VJP ``_fused_layer_bwd`` at 483, kernels
``_layer_kernel`` at 185 and ``_layer_bwd_kernel`` at 277, oracle
``reference_layer`` at 542).  The TPU kernels run in a (N, H, C, W)
layout; here activations stay NHWC and the kernels are
``csrc/convchain.cu`` (forward) and ``csrc/convchain_bwd.cu`` (backward,
two launches: dx and d(a, b), then dW and dbias), built by
``ops/cuda_build.py``.

:func:`fused_conv_layer` is a ``torch.autograd.Function``: for a CUDA
tensor its forward and backward launch those kernels; for a CPU tensor
they take :func:`reference_layer` and :func:`reference_layer_bwd`, the
plain PyTorch versions of the same functions.  A CUDA tensor never falls
back to the plain versions.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

# Launches of the CUDA kernels in this process (the plain versions do not
# count): the forward adds 1 per call, the backward 2 (its two launches).
launches = 0
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Agreement of the kernel with reference_layer on the same inputs: bounds on
# max |dy|, |ds1|, |ds2| as fractions of max |y|, of sum |y| and of sum y^2
# (the largest channel's).  In f32 only the order of summation differs (the
# 9*Cin products, and the atomics across blocks for the sums).  In bf16 one
# f32 ulp of difference can move an output's rounding by one bf16 ulp, so y
# gets 2 ulps of its magnitude, s1 one ulp per element and s2 two.
TOLERANCE = {torch.float32: (1e-4, 1e-4, 1e-4), torch.bfloat16: (1 / 64, 1 / 256, 1 / 128)}
# Agreement of the backward kernels with reference_layer_bwd: bounds on
# max |error| as fractions of max |ref| for dx, dW, dbias, d(a, b).  The
# folded cotangent and the prologue are computed alike, so the results
# differ only in the order of their f32 sums (with atomics across blocks
# for dW, dbias and d(a, b)), in bf16 too since products of bf16 values
# are exact in f32.  dW, dbias and d(a, b) are sums over all N*H*W pixels,
# whose rounding grows as sqrt(N*H*W) ulps: their bound is the larger of
# the value here and 8 * sqrt(N*H*W) * 2^-23 (5e-4 at 16 x 128^2 pixels,
# where 7e-5 was measured).  The bf16 dx is rounded from an f32 value that
# may differ by an ulp, so it gets 2 bf16 ulps of its magnitude.
BWD_TOLERANCE = {
    torch.float32: {"dx": 1e-4, "dw": 1e-4, "dbias": 1e-4, "dab": 1e-4},
    torch.bfloat16: {"dx": 1 / 64, "dw": 1e-4, "dbias": 1e-4, "dab": 1e-4},
}
# Blocks that the dW kernel aims to run (132 SMs x 8): the pixel reduction
# is split over grid.z until the grid holds about this many.
_DW_TARGET_BLOCKS = 1056
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


def reference_layer_bwd(x, weight, y, gy, gs1, gs2, ab=None):
    """Plain PyTorch version of the backward kernels (any device).

    x, y, gy: (N, H, W, Cin|Cout) in the activation dtype; gs1, gs2: f32
    (Cout,) cotangents of the sums.  Returns dx (x's dtype), dW (Cout, Cin,
    3, 3) f32, dbias f32 and d(a, b) (2, Cin) f32 (None without ``ab``).

    The rounding is the TPU kernel's (``_layer_bwd_kernel``): the stat
    cotangents fold as ``g = gy + (gs1 + 2*y*gs2)`` with the fold in f32
    rounded to the dtype; dW and dx come from autograd of the f32 conv of
    ``reference_layer`` on the rounded operands, so the prologue's
    cotangent stays f32 until dx is rounded once.
    """
    dt = x.dtype
    g = gy.to(dt) + (gs1 + 2.0 * y.float() * gs2).to(dt)
    gf = g.float()
    if ab is not None:
        z = x.float() * ab[0] + ab[1]
        h = torch.relu(z).to(dt)
    else:
        h = x
    with torch.enable_grad():
        hf = h.permute(0, 3, 1, 2).float().detach().requires_grad_()
        wf = weight.detach().to(dt).float().requires_grad_()
        out = F.conv2d(hf, wf, padding=1)
        dh, dw = torch.autograd.grad(out, (hf, wf), gf.permute(0, 3, 1, 2))
    dh = dh.permute(0, 2, 3, 1)
    dbias = gf.sum(dim=(0, 1, 2))
    if ab is None:
        return dh.to(dt).contiguous(), dw, dbias, None
    dz = dh * (z > 0)
    dab = torch.stack([(dz * x.float()).sum(dim=(0, 1, 2)), dz.sum(dim=(0, 1, 2))])
    return (dz * ab[0]).to(dt).contiguous(), dw, dbias, dab


def bwd_errors(got, ref):
    """Errors of ``got`` = (dx, dW, dbias, dab) against ``ref`` under
    :data:`BWD_TOLERANCE` and the pixel-count bound of the sums: {"dx":
    (max abs error, relative error, bound on the abs error), ...},
    relative to max |ref|.  ``dab`` is skipped when ``ref`` has none."""
    tol = BWD_TOLERANCE[ref[0].dtype]
    pixels = ref[0].numel() // ref[0].shape[-1]
    sum_tol = 8 * pixels**0.5 * 2.0**-23
    out = {}
    for name, g, r in zip(("dx", "dw", "dbias", "dab"), got, ref):
        if r is None:
            continue
        err = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        bound = tol[name] if name == "dx" else max(tol[name], sum_tol)
        out[name] = (err, err / scale if scale else 0.0, bound * scale)
    return out


@functools.cache
def _fwd_fn():
    fn = cuda_build.load("convchain").convchain_fwd
    fn.argtypes = [_VOID_P] * 7 + [_INT] * 7 + [_VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _bwd_fn():
    fn = cuda_build.load("convchain_bwd").convchain_bwd
    fn.argtypes = [_VOID_P] * 10 + [_INT] * 8 + [_VOID_P]
    fn.restype = _INT
    return fn


def kernel_weight(weight, dtype):
    """(Cout, Cin, 3, 3) -> the kernel's (9, Cin, Cout) [tap][cin][cout]
    layout, contiguous, in the activation dtype."""
    cout, cin = weight.shape[:2]
    return weight.to(dtype).permute(2, 3, 1, 0).reshape(9, cin, cout).contiguous()


def _dw_splits(n, h, w, cin, cout):
    """Blocks that share each dW tile's pixel reduction (grid.z of the dW
    kernel): enough for about ``_DW_TARGET_BLOCKS`` blocks, at most one
    8x8 pixel tile each."""
    tiles = n * -(-h // 8) * -(-w // 8)
    blocks = -(-cin // 16) * -(-cout // 64)
    return max(1, min(tiles, 65535, -(-_DW_TARGET_BLOCKS // blocks)))


def _check(x, weight, bias, ab):
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_layer takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_conv_layer takes float32 or bfloat16 activations, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("fused_conv_layer takes a contiguous (N, H, W, Cin) tensor")
    cin = x.shape[3]
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


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_fwd(x, weight, bias, ab):
    global launches
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    wk = kernel_weight(weight, x.dtype)
    bk = bias.to(x.dtype).contiguous()
    abk = ab.contiguous() if ab is not None else None
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    s1 = torch.zeros(cout, dtype=torch.float32, device=x.device)
    s2 = torch.zeros(cout, dtype=torch.float32, device=x.device)
    fn = _fwd_fn()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), wk.data_ptr(), bk.data_ptr(), abk.data_ptr() if abk is not None else None,
            y.data_ptr(), s1.data_ptr(), s2.data_ptr(),
            n, h, w, cin, cout, _DTYPE_CODE[x.dtype], int(abk is not None), _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"convchain_fwd launch failed with CUDA error {err}")
    launches += 1
    return y, s1, s2


def _launch_bwd(x, weight, y, gy, gs1, gs2, ab):
    global bwd_launches
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    # (9, Cout, Cin), taps flipped: the dx pass is a forward conv of g
    wt = weight.to(x.dtype).flip(2, 3).permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()
    gy = gy.to(x.dtype).contiguous()
    gs = torch.stack([gs1, gs2]).float().contiguous()
    abk = ab.contiguous() if ab is not None else None
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty_like(x)
    dw = torch.zeros((9, cin, cout), **f32)
    dbias = torch.zeros(cout, **f32)
    dab = torch.zeros((2, cin), **f32) if ab is not None else None
    fn = _bwd_fn()
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(), wt.data_ptr(), y.data_ptr(), gy.data_ptr(), gs.data_ptr(),
            abk.data_ptr() if abk is not None else None, dx.data_ptr(), dw.data_ptr(),
            dbias.data_ptr(), dab.data_ptr() if dab is not None else None,
            n, h, w, cin, cout, _DTYPE_CODE[x.dtype], int(abk is not None),
            _dw_splits(n, h, w, cin, cout), _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"convchain_bwd launch failed with CUDA error {err}")
    bwd_launches += 2
    # (9, Cin, Cout) [ky*3+kx][ci][co] -> (Cout, Cin, 3, 3)
    return dx, dw.view(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous(), dbias, dab


class _FusedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, ab):
        if x.device.type == "cpu":
            y, s1, s2 = reference_layer(x, weight, bias, ab)
        else:
            _check(x, weight, bias, ab)
            y, s1, s2 = _launch_fwd(x, weight, bias, ab)
        ctx.save_for_backward(x, weight, ab, y)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, weight, ab, y = ctx.saved_tensors
        bwd = reference_layer_bwd if x.device.type == "cpu" else _launch_bwd
        dx, dw, dbias, dab = bwd(x, weight, y, gy, gs1, gs2, ab)
        return dx, dw.to(weight.dtype), dbias.to(weight.dtype), dab


def fused_conv_layer(x, weight, bias, ab=None):
    """y, s1, s2 of :func:`reference_layer`, by the CUDA kernels when ``x``
    lies on a CUDA device; differentiable in x, weight, bias and ab.
    ``ab=None`` skips the prologue (chain entry).  A caller that wants the
    model's train-mode semantics passes ``bias.detach()``
    (pssr2_tpu/models/blocks.py:SGBiasConv)."""
    return _FusedLayer.apply(x, weight, bias, ab)
