"""The RDNet block tail, LayerNorm -> fc1 (1x1) -> GELU -> fc2 (1x1), on
flattened rows, and its VJP.

Counterpart: pssr2_tpu/ops/pallas/rdtail.py (``fused_rd_tail`` at 253
with its custom VJP ``_tail_fn`` at 230, kernels ``_tail_kernel`` at 109
and ``_tail_bwd_kernel`` at 117, oracle ``reference_tail`` at 218).  The
GELU, LayerNorm and product helpers it shares with the Swin block are in
``ops/blockmath.py``.

The kernels are ``csrc/rdtail.cu``, built by ``ops/cuda_build.py``: the
forward is one launch (the ``inter``-wide intermediate stays on chip); the
backward is two (the per-row gradient chain, then the weight gradients'
reduction over all rows).

:func:`fused_rd_tail` is a ``torch.autograd.Function``: for a CUDA tensor
its forward and backward launch those kernels; for a CPU tensor they take
:func:`reference_tail` and :func:`reference_tail_bwd`, the plain PyTorch
versions of the same functions.  A CUDA tensor never falls back to them.
"""

import ctypes
import functools

import torch

from . import cuda_build
from .blockmath import (  # noqa: F401  (the GELU helpers are part of this module's surface)
    _dgelu,
    _dgelu_exact,
    _dgelu_fast,
    _gelu,
    _gelu_exact,
    _gelu_fast,
    _layernorm,
    _layernorm_bwd,
    _matmul,
    _matmul_dw,
    _matmul_dx,
)

# Launches of the CUDA kernels in this process (the plain versions do not
# count): the forward adds 1 per call, the backward 2 (its two launches).
launches = 0
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# What csrc/rdtail.cu takes: G output channels at most MAX_G (its fc2
# accumulators live in registers), and C input channels whose normalised
# row tile fits the 227 KB of shared memory a block may use.
MAX_G = 256
MAX_C = 1408

# Agreement of the kernels with the plain versions on the same inputs:
# bounds on max |error| as fractions of max |ref|.  In f32 only the order of
# the f32 sums differs (over C, inter and G in the products and the
# LayerNorm statistics).  In bf16 one f32 ulp of difference can move a
# rounding to bf16 by one bf16 ulp: the outputs and dx get 2 bf16 ulps of
# their magnitude.  The parameter gradients are f32 sums over all M rows,
# whose rounding grows as sqrt(M) ulps: their bound is the larger of the
# value here and 8 * sqrt(M) * 2^-23; in bf16 their terms are bf16 values
# that may differ by an ulp, so they get one bf16 ulp of their magnitude.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1 / 64}
BWD_TOLERANCE = {
    torch.float32: {"dx": 1e-4, "param": 1e-4},
    torch.bfloat16: {"dx": 1 / 64, "param": 1 / 256},
}
GRAD_NAMES = ("dx", "dlns", "dlnb", "dw1", "db1", "dw2", "db2")

def reference_tail(x, lns, lnb, w1, b1, w2, b2, *, eps):
    """Plain PyTorch version of the forward kernel (any device).

    x: (M, C) float32 or bfloat16 rows; lns, lnb: (C,); w1: (C, inter);
    b1: (inter,); w2: (inter, G); b2: (G,).  Returns (M, G) in x's dtype.
    The GELU is the polynomial one for bf16 and the exact one for f32."""
    h = _layernorm(x, lns, lnb, eps)
    return _matmul(_gelu(_matmul(h, w1, b1)), w2, b2)


def reference_tail_bwd(x, lns, lnb, w1, b1, w2, b2, g, *, eps):
    """Plain PyTorch version of the backward kernels (any device), with the
    rounding of ``_tail_bwd_kernel``: the forward recomputed, ``dz``
    rounded to x's dtype, then ``dz * dgelu(z1)`` rounded to it; the
    parameter gradients in f32.  Returns (dx, dlns, dlnb, dw1, db1, dw2,
    db2): dx in x's dtype, the rest f32."""
    dt = x.dtype
    h = _layernorm(x, lns, lnb, eps)
    z1 = _matmul(h, w1, b1)
    zg = _gelu(z1)
    g = g.to(dt)
    dw2 = _matmul_dw(zg, g)
    db2 = g.float().sum(dim=0)
    dz = _matmul_dx(g, w2)
    dz1 = (dz.float() * _dgelu(z1)).to(dt)
    dw1 = _matmul_dw(h, dz1)
    db1 = dz1.float().sum(dim=0)
    dh = _matmul_dx(dz1, w1)
    dx, dlns, dlnb = _layernorm_bwd(x, lns, eps, dh)
    return dx, dlns, dlnb, dw1, db1, dw2, db2


def errors(got, ref):
    """Errors of the forward output ``got`` against ``ref`` under
    :data:`TOLERANCE`: (max abs error, relative error, bound on the abs
    error), relative to max |ref|."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, err / scale if scale else 0.0, TOLERANCE[ref.dtype] * scale


def bwd_errors(got, ref):
    """Errors of the seven gradients ``got`` against ``ref`` under
    :data:`BWD_TOLERANCE` and the row-count bound of the parameter
    gradients: {"dx": (max abs error, relative error, bound on the abs
    error), "dlns": ..., ...}, relative to max |ref|."""
    tol = BWD_TOLERANCE[ref[0].dtype]
    sum_tol = 8 * ref[0].shape[0] ** 0.5 * 2.0**-23
    out = {}
    for name, g, r in zip(GRAD_NAMES, got, ref):
        err = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        bound = tol["dx"] if name == "dx" else max(tol["param"], sum_tol)
        out[name] = (err, err / scale if scale else 0.0, bound * scale)
    return out


@functools.cache
def _fwd_fn():
    fn = cuda_build.load("rdtail").rdtail_fwd
    fn.argtypes = [_VOID_P] * 8 + [_INT] * 5 + [_FLOAT, _VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _bwd_fn():
    fn = cuda_build.load("rdtail").rdtail_bwd
    fn.argtypes = [_VOID_P] * 18 + [_INT] * 6 + [_FLOAT, _VOID_P]
    fn.restype = _INT
    return fn


def _check(x, params):
    if x.device.type != "cuda":
        raise ValueError(f"fused_rd_tail takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_rd_tail takes float32 or bfloat16 rows, got {x.dtype}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"fused_rd_tail takes (M, C) rows with M, C >= 1, got {tuple(x.shape)}")
    c = x.shape[1]
    lns, lnb, w1, b1, w2, b2 = params
    inter, g = w1.shape[-1], w2.shape[-1]
    want = ((c,), (c,), (c, inter), (inter,), (inter, g), (g,))
    if tuple(tuple(p.shape) for p in params) != want:
        raise ValueError(
            f"parameters {[tuple(p.shape) for p in params]} do not fit x {tuple(x.shape)}: expected {list(want)}"
        )
    if g > MAX_G or c > MAX_C:
        raise ValueError(f"fused_rd_tail takes C <= {MAX_C} and G <= {MAX_G}, got C {c}, G {g}")
    if any(p.device != x.device for p in params):
        raise ValueError("fused_rd_tail: all inputs must be on x's device")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _kernel_params(x, params):
    """The parameters in x's dtype, contiguous: fc1 as (C, inter), fc2 as
    (inter, G), the layouts the forward reads."""
    return tuple(p.detach().to(x.dtype).contiguous() for p in params)


def _launch_fwd(x, params, eps):
    global launches
    m, c = x.shape
    inter, g = params[2].shape[-1], params[4].shape[-1]
    lns, lnb, w1, b1, w2, b2 = _kernel_params(x, params)
    x = x.contiguous()
    out = torch.empty((m, g), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = _fwd_fn()(
            x.data_ptr(), lns.data_ptr(), lnb.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), m, c, inter, g, _DTYPE_CODE[x.dtype], eps, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"rdtail_fwd launch failed with CUDA error {err}")
    launches += 1
    return out


# Blocks that the weight-gradient launch aims to run (132 SMs x 8): the
# row reduction is split over grid.y until the grid holds about this many.
_DW_TARGET_BLOCKS = 1056


def _dw_splits(m, c, inter, g):
    """Row splits of the weight-gradient launch: enough for about
    ``_DW_TARGET_BLOCKS`` blocks of 64x64 tiles, at least 64 rows each."""
    tiles = -(-c // 64) * -(-inter // 64) + -(-inter // 64) * -(-g // 64)
    return max(1, min(-(-m // 64), 65535, -(-_DW_TARGET_BLOCKS // tiles)))


def _launch_bwd(x, params, gout, eps):
    """(dx, dlns, dlnb, dw1, db1, dw2, db2) by the two backward launches;
    the parameter gradients in f32."""
    global bwd_launches
    m, c = x.shape
    inter, g = params[2].shape[-1], params[4].shape[-1]
    lns, lnb, w1, b1, w2, _ = _kernel_params(x, params)
    # the backward also reads fc1 as (inter, C) and fc2 as (G, inter)
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    x = x.contiguous()
    gout = gout.to(x.dtype).contiguous()
    dt = {"dtype": x.dtype, "device": x.device}
    f32 = {"dtype": torch.float32, "device": x.device}
    # scratch for the weight-gradient launch: the normalised rows, GELU(z1)
    # and dz1, in x's dtype
    h, zg, dz1 = torch.empty((m, c), **dt), torch.empty((m, inter), **dt), torch.empty((m, inter), **dt)
    dx = torch.empty_like(x)
    dlns, dlnb, db1, db2 = (torch.zeros(n, **f32) for n in (c, c, inter, g))
    dw1, dw2 = torch.zeros((c, inter), **f32), torch.zeros((inter, g), **f32)
    ptrs = (x, lns, lnb, w1, w1t, b1, w2t, gout, h, zg, dz1, dx, dlns, dlnb, dw1, db1, dw2, db2)
    with torch.cuda.device(x.device):
        err = _bwd_fn()(
            *(t.data_ptr() for t in ptrs),
            m, c, inter, g, _DTYPE_CODE[x.dtype], _dw_splits(m, c, inter, g), eps, _stream(x.device),
        )
    if err != 0:
        raise RuntimeError(f"rdtail_bwd launch failed with CUDA error {err}")
    bwd_launches += 2
    return dx, dlns, dlnb, dw1, db1, dw2, db2


class _FusedTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lns, lnb, w1, b1, w2, b2, eps):
        params = (lns, lnb, w1, b1, w2, b2)
        if x.device.type == "cpu":
            out = reference_tail(x, *params, eps=eps)
        else:
            _check(x, params)
            out = _launch_fwd(x, params, eps)
        ctx.save_for_backward(x, *params)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, gout):
        x, *params = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = reference_tail_bwd(x, *params, gout, eps=ctx.eps)
        else:
            grads = _launch_bwd(x, params, gout, ctx.eps)
        dx, *dparams = grads
        return (dx, *(d.to(p.dtype) for d, p in zip(dparams, params)), None)


def fused_rd_tail(x, lns, lnb, w1, b1, w2, b2, *, eps):
    """LayerNorm -> fc1 -> GELU -> fc2 on rows ``x`` (M, C), by the CUDA
    kernels when ``x`` lies on a CUDA device; returns (M, G) in x's dtype.
    The parameters are cast to x's dtype inside, so their gradients come
    back in their own dtype (f32), as ``_tail_fn`` returns them."""
    return _FusedTail.apply(x, lns, lnb, w1, b1, w2, b2, float(eps))
