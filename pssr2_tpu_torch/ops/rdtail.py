"""The RDNet block tail, LayerNorm -> fc1 (1x1) -> GELU -> fc2 (1x1), on
flattened rows, and its VJP.

Counterpart: pssr2_tpu/ops/pallas/rdtail.py (``fused_rd_tail`` at 253
with its custom VJP ``_tail_fn`` at 230, kernels ``_tail_kernel`` at 109
and ``_tail_bwd_kernel`` at 117, oracle ``reference_tail`` at 218), and
the helpers it takes from pssr2_tpu/ops/pallas/swinblock.py (``_erf_f32``,
``_gelu_exact``, ``_gelu_fast``, ``_layernorm``, ``_matmul`` at 60-130;
``_dgelu_fast``, ``_dgelu_exact``, ``_layernorm_bwd``, ``_matmul_dx``,
``_matmul_dw`` at 441-496), copied here so that the port imports nothing
of the JAX package.

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

import numpy as np
import torch

from . import cuda_build

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

# XLA's erf rational on [-4, 4] (pssr2_tpu/ops/pallas/swinblock.py:53-58)
_ERF_ALPHA = (-2.72614225801306e-10, 2.77068142495902e-08, -2.10102402082508e-06,
              -5.69250639462346e-05, -7.34990630326855e-04, -2.95459980854025e-03,
              -1.60960333262415e-02)
_ERF_BETA = (-1.45660718464996e-05, -2.13374055278905e-04, -1.68282697438203e-03,
             -7.37332916720468e-03, -1.42647390514189e-02)
# gelu(x) = 0.5x + x^2 S(x^2) on [-4, 4] (swinblock.py:86-93), and S'
_GELU_S = (0.398714550644521, -0.0659565049580834, 0.009545222431626374,
           -0.0010175056451836898, 7.648234117739626e-05,
           -3.7887493429360835e-06, 1.0968829398043447e-07,
           -1.3937041721878255e-09)
_GELU_SP = tuple(k * c for k, c in enumerate(_GELU_S))[1:]
_SQRT_HALF = float(np.float32(np.sqrt(0.5)))
_INV_SQRT_2PI = float(np.float32(1.0 / np.sqrt(2.0 * np.pi)))


def _is_fast(dtype):
    """The polynomial GELU for bf16 compute, the exact one for f32
    (the JAX package's ``FAST_GELU = "auto"``)."""
    return dtype == torch.bfloat16


def _erf_f32(x):
    xc = x.clamp(-4.0, 4.0)
    x2 = xc * xc

    def poly(cs):
        a = torch.full_like(x2, cs[0])
        for c in cs[1:]:
            a = a * x2 + c
        return a

    return xc * poly(_ERF_ALPHA) / poly(_ERF_BETA)


def _gelu_exact(x):
    xf = x.float()
    return (0.5 * xf * (1.0 + _erf_f32(xf * _SQRT_HALF))).to(x.dtype)


def _poly_u(u, cs):
    acc = torch.full_like(u, cs[-1])
    for c in cs[-2::-1]:
        acc = acc * u + c
    return acc


def _gelu_fast(x):
    xf = x.float()
    xc = xf.clamp(-4.0, 4.0)
    u = xc * xc
    y = 0.5 * xc + u * _poly_u(u, _GELU_S)
    y = torch.where(xf > 4.0, xf, torch.where(xf < -4.0, torch.zeros_like(y), y))
    return y.to(x.dtype)


def _dgelu_fast(x):
    xf = x.float()
    xc = xf.clamp(-4.0, 4.0)
    u = xc * xc
    g = 0.5 + 2.0 * xc * (_poly_u(u, _GELU_S) + u * _poly_u(u, _GELU_SP))
    return torch.where(xf > 4.0, torch.ones_like(g), torch.where(xf < -4.0, torch.zeros_like(g), g))


def _dgelu_exact(x):
    xf = x.float()
    phi = torch.exp(-0.5 * xf * xf) * _INV_SQRT_2PI
    return 0.5 * (1.0 + _erf_f32(xf * _SQRT_HALF)) + xf * phi


def _stats(xf):
    """f32 row mean and fast variance max(0, E[x^2] - mu^2), keepdim."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return mu, var


def _layernorm(x, scale, bias, eps):
    """flax nnx.LayerNorm semantics: scale and bias rounded to x's dtype
    first, f32 statistics, the output rounded to x's dtype."""
    dt = x.dtype
    mu, var = _stats(x.float())
    mul = torch.rsqrt(var + eps) * scale.to(dt).float()
    return ((x.float() - mu) * mul + bias.to(dt).float()).to(dt)


def _matmul(x, w, b):
    """nnx.Linear semantics: w in x's dtype, f32 accumulation, the product
    rounded to x's dtype, then the bias added in x's dtype."""
    dt = x.dtype
    return (x.float() @ w.to(dt).float()).to(dt) + b.to(dt)


def _matmul_dx(g, w):
    """g @ w^T under the same policy (no bias)."""
    return (g.float() @ w.to(g.dtype).float().t()).to(g.dtype)


def _matmul_dw(x, g):
    """x^T @ g over the rows, in f32."""
    return x.float().t() @ g.float()


def _layernorm_bwd(x, gamma, eps, dy):
    """VJP of :func:`_layernorm` at ``x``: (dx, dgamma, dbeta), the
    statistics recomputed alike."""
    xf = x.float()
    mu, var = _stats(xf)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    dyf = dy.float()
    dgamma = (dyf * xhat).sum(dim=0)
    dbeta = dyf.sum(dim=0)
    dxhat = dyf * gamma.to(x.dtype).float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype), dgamma, dbeta


def reference_tail(x, lns, lnb, w1, b1, w2, b2, *, eps):
    """Plain PyTorch version of the forward kernel (any device).

    x: (M, C) float32 or bfloat16 rows; lns, lnb: (C,); w1: (C, inter);
    b1: (inter,); w2: (inter, G); b2: (G,).  Returns (M, G) in x's dtype.
    The GELU is the polynomial one for bf16 and the exact one for f32."""
    h = _layernorm(x, lns, lnb, eps)
    z = _matmul(h, w1, b1)
    z = _gelu_fast(z) if _is_fast(z.dtype) else _gelu_exact(z)
    return _matmul(z, w2, b2)


def reference_tail_bwd(x, lns, lnb, w1, b1, w2, b2, g, *, eps):
    """Plain PyTorch version of the backward kernels (any device), with the
    rounding of ``_tail_bwd_kernel``: the forward recomputed, ``dz``
    rounded to x's dtype, then ``dz * dgelu(z1)`` rounded to it; the
    parameter gradients in f32.  Returns (dx, dlns, dlnb, dw1, db1, dw2,
    db2): dx in x's dtype, the rest f32."""
    dt = x.dtype
    h = _layernorm(x, lns, lnb, eps)
    z1 = _matmul(h, w1, b1)
    fast = _is_fast(dt)
    zg = _gelu_fast(z1) if fast else _gelu_exact(z1)
    g = g.to(dt)
    dw2 = _matmul_dw(zg, g)
    db2 = g.float().sum(dim=0)
    dz = _matmul_dx(g, w2)
    dgel = _dgelu_fast(z1) if fast else _dgelu_exact(z1)
    dz1 = (dz.float() * dgel).to(dt)
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
