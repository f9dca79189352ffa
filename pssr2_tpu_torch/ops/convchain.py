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
``ops/cuda_build.py``.  Each has two routes, picked from the dtype before
the launch: bfloat16 runs an implicit GEMM on the tensor cores (wgmma;
``csrc/convchain_tc.cuh``, tiled by :func:`tc_plan` and
:func:`tc_dw_plan`), float32 a direct convolution on the CUDA cores.

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

_DTYPES = (torch.float32, torch.bfloat16)

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
# Blocks that the f32 dW kernel aims to run (132 SMs x 8): the pixel
# reduction is split over grid.z until the grid holds about this many.
_DW_TARGET_BLOCKS = 1056
# The bf16 (tensor-core) kernels: a sub-tile is TILE x TILE output pixels
# (64 rows of M, one warpgroup's); K comes in chunks of K_CHUNK channels, to
# which the weight layouts are zero-padded.  The forward and dx grids take
# the largest tiles that still give about _TC_TARGET_BLOCKS blocks (two per
# SM of 132); the dW grid (one block per SM at a time) splits its pixel
# reduction until it holds _TC_DW_TARGET_BLOCKS, at most _TC_DW_MAX_SPLITS
# ways (a sweep on the H100 found both limits).
TILE = 8
K_CHUNK = 64
_TC_TARGET_BLOCKS = 256
_TC_DW_TARGET_BLOCKS = 264
_TC_DW_MAX_SPLITS = 64
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
    fn.argtypes = [_VOID_P] * 7 + [_INT] * 6 + [_VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _bwd_fn():
    fn = cuda_build.load("convchain_bwd").convchain_bwd
    fn.argtypes = [_VOID_P] * 10 + [_INT] * 7 + [_VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _fwd_tc_fn():
    fn = cuda_build.load("convchain").convchain_fwd_tc
    fn.argtypes = [_VOID_P] * 7 + [_INT] * 9 + [_VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _bwd_tc_fn():
    fn = cuda_build.load("convchain_bwd").convchain_bwd_tc
    fn.argtypes = [_VOID_P] * 12 + [_INT] * 11 + [_VOID_P]
    fn.restype = _INT
    return fn


def _padded(n):
    return -(-n // K_CHUNK) * K_CHUNK


def kernel_weight(weight, dtype):
    """(Cout, Cin, 3, 3) -> the forward kernel's weight layout, contiguous,
    in the activation dtype: for float32 (9, Cin, Cout) [tap][cin][cout]
    (the CUDA-core kernel); for bfloat16 (9, Cout, Cin_pad) [tap][cout][cin],
    K-major and zero for Cin <= k < Cin_pad (Cin rounded up to K_CHUNK), the
    tensor-core kernel's B operand."""
    cout, cin = weight.shape[:2]
    if dtype == torch.float32:
        return weight.to(dtype).permute(2, 3, 1, 0).reshape(9, cin, cout).contiguous()
    kpad = _padded(cin)
    wk = torch.empty((9, cout, kpad), dtype=dtype, device=weight.device)
    wk.view(3, 3, cout, kpad)[..., :cin].copy_(weight.permute(2, 3, 0, 1))
    if kpad > cin:
        wk[..., cin:].zero_()
    return wk


def kernel_weight_dx(weight):
    """(Cout, Cin, 3, 3) -> the f32 dx kernel's weight layout (9, Cout,
    Cin) [8 - tap][cout][cin], contiguous: the taps flipped (the dx pass is
    a forward conv of the cotangent).  The bf16 dx kernel reads
    :func:`kernel_weight`'s layout at tap 8 - t instead, as [cout][cin]."""
    cout, cin = weight.shape[:2]
    return weight.float().flip(2, 3).permute(2, 3, 0, 1).reshape(9, cout, cin).contiguous()


def _dw_splits(n, h, w, cin, cout):
    """Blocks that share each f32 dW tile's pixel reduction (grid.z of the
    f32 dW kernel): enough for about ``_DW_TARGET_BLOCKS`` blocks, at most
    one 8x8 pixel tile each."""
    tiles = n * -(-h // 8) * -(-w // 8)
    blocks = -(-cin // 16) * -(-cout // 64)
    return max(1, min(tiles, 65535, -(-_DW_TARGET_BLOCKS // blocks)))


def sub_tiles(n, h, w):
    """Number of TILE x TILE pixel sub-tiles of an (n, h, w) batch."""
    return n * -(-h // TILE) * -(-w // TILE)


def sub_tile_origin(t, n, h, w):
    """(image, first row, first column) of sub-tile ``t``: image by image,
    row-major inside an image, as the kernels number them
    (``csrc/convchain_tc.cuh:sub_origin``)."""
    tiles_w = -(-w // TILE)
    per_img = tiles_w * -(-h // TILE)
    img, r = divmod(t, per_img)
    return img, (r // tiles_w) * TILE, (r % tiles_w) * TILE


@functools.cache
def tc_plan(n, h, w, nch):
    """Tiling of the bf16 forward (``nch`` = Cout) or dx (``nch`` = Cin)
    kernel: ``(wg, bn, (grid_x, grid_y))``.  Block (bx, by) computes
    channels [by * bn, by * bn + bn) of sub-tiles bx * wg + i, i < wg, one
    warpgroup each.  The first of (2, 128), (1, 128), (1, 64) (with nch <=
    64: (2, 64), (1, 64)) that gives _TC_TARGET_BLOCKS blocks, else the
    last."""
    n_sub = sub_tiles(n, h, w)
    configs = ((2, 64), (1, 64)) if nch <= 64 else ((2, 128), (1, 128), (1, 64))
    for wg, bn in configs:
        grid = (-(-n_sub // wg), -(-nch // bn))
        if grid[0] * grid[1] >= _TC_TARGET_BLOCKS:
            break
    return wg, bn, grid


@functools.cache
def tc_dw_plan(n, h, w, cin, cout):
    """Grid of the bf16 dW kernel: ``(grid_x, grid_y, splits)``.  Block
    (bx, by, bz) computes all 9 taps of dW for Cin rows [64 bx, + 64) and
    Cout columns [64 by, + 64), summed over sub-tiles bz, bz + splits, ...;
    splits grows until the grid holds _TC_DW_TARGET_BLOCKS blocks, at most
    _TC_DW_MAX_SPLITS: more partial sums of one dW entry contend in its
    atomics more than their blocks gain."""
    grid = (-(-cin // 64), -(-cout // 64))
    splits = -(-_TC_DW_TARGET_BLOCKS // (grid[0] * grid[1]))
    return (*grid, max(1, min(sub_tiles(n, h, w), _TC_DW_MAX_SPLITS, splits)))


def _check(x, weight, bias, ab):
    if x.device.type != "cuda":
        raise ValueError(f"fused_conv_layer takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES:
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


def _launch_fwd(x, weight, bias, ab, wk=None):
    """The forward launch; ``wk``: :func:`kernel_weight` of ``weight`` where
    the caller holds it."""
    global launches
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    wk = kernel_weight(weight, x.dtype) if wk is None else wk
    bk = bias.float().contiguous()
    abk = ab.contiguous() if ab is not None else None
    y = torch.empty((n, h, w, cout), dtype=x.dtype, device=x.device)
    s1, s2 = torch.zeros((2, cout), dtype=torch.float32, device=x.device)
    ptrs = (x.data_ptr(), wk.data_ptr(), bk.data_ptr(), abk.data_ptr() if abk is not None else None,
            y.data_ptr(), s1.data_ptr(), s2.data_ptr())
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            wg, bn, _ = tc_plan(n, h, w, cout)
            err = _fwd_tc_fn()(*ptrs, n, h, w, cin, cout, wk.shape[2], int(abk is not None), wg, bn,
                               _stream(x.device))
        else:
            err = _fwd_fn()(*ptrs, n, h, w, cin, cout, int(abk is not None), _stream(x.device))
    if err != 0:
        raise RuntimeError(f"convchain_fwd launch failed with CUDA error {err}")
    launches += 1
    return y, s1, s2


def _launch_bwd(x, weight, y, gy, gs1, gs2, ab, wk=None):
    """The two backward launches; ``wk``: the bf16 forward's
    :func:`kernel_weight` of ``weight`` where the caller holds it."""
    global bwd_launches
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    gy = gy.to(x.dtype).contiguous()
    abk = ab.contiguous() if ab is not None else None
    dx = torch.empty_like(x)
    # dW, dbias and d(a, b), summed by atomics: one zeroed buffer
    sums = torch.zeros(9 * cin * cout + cout + 2 * cin, dtype=torch.float32, device=x.device)
    dbias = sums[9 * cin * cout:9 * cin * cout + cout]
    dab = sums[9 * cin * cout + cout:].view(2, cin) if ab is not None else None
    outs = (abk.data_ptr() if abk is not None else None, dx.data_ptr(), sums.data_ptr(), dbias.data_ptr(),
            dab.data_ptr() if dab is not None else None)
    with torch.cuda.device(x.device):
        if x.dtype == torch.bfloat16:
            wk = kernel_weight(weight, x.dtype) if wk is None else wk
            g = torch.empty((n, h, w, _padded(cout)), dtype=x.dtype, device=x.device)  # the folded cotangent
            dx_wg, dx_bn, _ = tc_plan(n, h, w, cin)
            gs1, gs2 = gs1.float().contiguous(), gs2.float().contiguous()
            err = _bwd_tc_fn()(x.data_ptr(), wk.data_ptr(), y.data_ptr(), gy.data_ptr(), gs1.data_ptr(),
                               gs2.data_ptr(), *outs, g.data_ptr(), n, h, w, cin, cout, wk.shape[2], g.shape[3],
                               int(abk is not None), dx_wg, dx_bn, tc_dw_plan(n, h, w, cin, cout)[2],
                               _stream(x.device))
            dw = sums[:9 * cin * cout].view(cout, cin, 3, 3)  # the kernel's own order
        else:
            wt = kernel_weight_dx(weight)
            gs = torch.stack([gs1, gs2]).float().contiguous()
            err = _bwd_fn()(x.data_ptr(), wt.data_ptr(), y.data_ptr(), gy.data_ptr(), gs.data_ptr(), *outs,
                            n, h, w, cin, cout, int(abk is not None), _dw_splits(n, h, w, cin, cout),
                            _stream(x.device))
            # (9, Cin, Cout) [ky*3+kx][ci][co] -> (Cout, Cin, 3, 3)
            dw = sums[:9 * cin * cout].view(3, 3, cin, cout).permute(3, 2, 0, 1).contiguous()
    if err != 0:
        raise RuntimeError(f"convchain_bwd launch failed with CUDA error {err}")
    bwd_launches += 2
    return dx, dw, dbias, dab


class _FusedLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, ab):
        wk = None
        if x.device.type == "cpu":
            y, s1, s2 = reference_layer(x, weight, bias, ab)
        else:
            _check(x, weight, bias, ab)
            if x.dtype == torch.bfloat16:  # kept for the backward, which reads the same layout
                wk = kernel_weight(weight, x.dtype)
            y, s1, s2 = _launch_fwd(x, weight, bias, ab, wk)
        ctx.save_for_backward(x, weight, ab, y, wk)
        return y, s1, s2

    @staticmethod
    def backward(ctx, gy, gs1, gs2):
        x, weight, ab, y, wk = ctx.saved_tensors
        if x.device.type == "cpu":
            dx, dw, dbias, dab = reference_layer_bwd(x, weight, y, gy, gs1, gs2, ab)
        else:
            dx, dw, dbias, dab = _launch_bwd(x, weight, y, gy, gs1, gs2, ab, wk)
        return dx, dw.to(weight.dtype), dbias.to(weight.dtype), dab


def fused_conv_layer(x, weight, bias, ab=None):
    """y, s1, s2 of :func:`reference_layer`, by the CUDA kernels when ``x``
    lies on a CUDA device; differentiable in x, weight, bias and ab.
    ``ab=None`` skips the prologue (chain entry).  A caller that wants the
    model's train-mode semantics passes ``bias.detach()``
    (pssr2_tpu/models/blocks.py:SGBiasConv)."""
    return _FusedLayer.apply(x, weight, bias, ab)
