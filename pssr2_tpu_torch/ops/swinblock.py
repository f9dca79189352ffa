"""One whole Swin transformer block, LN1 -> qkv -> (shifted, masked) window
attention with the relative-position bias -> proj -> x s1 -> residual ->
LN2 -> fc1 -> GELU -> fc2 -> x s2 -> residual, and its VJP.

Counterpart: pssr2_tpu/ops/pallas/swinblock.py: ``fused_swin_block`` (926)
and ``fused_swin_block_train`` (981), kernels ``_block_kernel`` (329,
reached through ``_pallas_block`` 799) and ``_block_bwd_kernel`` (561,
``_pallas_block_bwd`` 662), oracle ``reference_block`` (853), the
attention ``_attention`` (216) and its VJP parts (500-558).  The kernel
computes the group labels of ``_window_group_labels`` (736) itself; the
plain versions take the mask of ``winattn.shift_attn_mask``.  The GELU, LayerNorm and product
helpers are shared with the RDNet tail (``ops/blockmath.py``).

Layout.  The TPU kernel chains blocks in "roll space" and realigns with
rolls; here a block takes and returns the canonical (B, H, W, C) tensor
and ``shift``: the kernel reads each window's tokens at the rolled
coordinates ((r + shift) mod H, (c + shift) mod W) and writes each output
token back to its own place.  Offsets are taken mod the image size.

Semantics are those of ``_block_kernel``: flax LayerNorm statistics, f32
accumulation rounded to the dtype and the bias added in the dtype, f32
scores plus the f32 bias map, the no-max softmax exp(s) * (1 / sum)
rounded to the dtype, the shift mask as -100 between tokens of different
group labels, the polynomial GELU in bf16 and the exact one in f32, and
the optional per-sample DropPath keep-scales s1, s2 multiplied in the
dtype.  The attention scale is folded into the q columns of W_qkv and
b_qkv by :func:`fused_swin_block`, so the block runs at scale 1.

The kernels are ``csrc/swinblock.cu``, built by ``ops/cuda_build.py``: the
forward is one launch (one thread block per window, everything between x
and the output on chip); the backward two (the per-window gradient chain,
then the weight gradients' and the bias map's reductions over all rows and
windows).  :func:`fused_swin_block` is a ``torch.autograd.Function``: for a
CUDA tensor its forward and backward launch those kernels; for a CPU
tensor they take :func:`reference_block` and :func:`reference_block_bwd`.
A CUDA tensor never falls back to them.
"""

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build, winattn
from .blockmath import _dgelu, _gelu, _layernorm, _layernorm_bwd, _matmul, _matmul_dw, _matmul_dx

# Launches of the CUDA kernels in this process (the plain versions do not
# count): the forward adds 1 per call, the backward 2 (its two launches).
launches = 0
bwd_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# What csrc/swinblock.cu takes.  A thread block holds one window's 64
# tokens in shared memory: f32 copies of x's LayerNorm, of q, k, v (3C
# channels, later their gradients) and of one head's 64 x 64 probabilities;
# the MLP's hidden activation takes the place of k and v.  With C <= 192
# and hidden <= 384 both kernels fit the 227 KB a block may use.
MAX_C = 192
MAX_HIDDEN = 384
MAX_N = 64  # tokens of a window, ws * ws
MAX_HEAD_DIM = 32

# Agreement of the kernels with the plain versions on the same inputs:
# bounds on max |error| as fractions of max |ref|.  In f32 only the order
# of the f32 sums differs.  In bf16 one f32 ulp of difference can move a
# rounding to bf16 by one bf16 ulp, and a moved probability or activation
# moves the outputs after it: the output gets 2 bf16 ulps of its magnitude,
# dx (which passes the chain back through both LayerNorms) 4.  The
# parameter gradients are f32 sums over all M rows, whose rounding grows as
# sqrt(M) ulps: their bound is the larger of the value here and
# 8 * sqrt(M) * 2^-23; in bf16 their terms are bf16 values that may differ
# by an ulp, so they get 2 bf16 ulps of their magnitude.
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1 / 64}
BWD_TOLERANCE = {
    torch.float32: {"dx": 1e-4, "param": 1e-4},
    torch.bfloat16: {"dx": 1 / 32, "param": 1 / 128},
}
PARAM_NAMES = ("ln1_s", "ln1_b", "wqkv", "bqkv", "wproj", "bproj", "ln2_s", "ln2_b", "w1", "b1", "w2", "b2",
               "bias")
GRAD_NAMES = ("dx",) + tuple("d" + p for p in PARAM_NAMES)


def _fold_scale(params, scale):
    """Fold the attention scale into the q columns of W_qkv (C, 3C) and
    b_qkv, in the parameters' dtype, with torch ops (autograd carries it)."""
    ln1_s, ln1_b, wqkv, bqkv, *rest = params
    if scale == 1.0:
        return params
    c = wqkv.shape[0]
    col = torch.ones(3 * c, dtype=wqkv.dtype, device=wqkv.device)
    col[:c] = scale
    return (ln1_s, ln1_b, wqkv * col, bqkv * col, *rest)


def _scale(s, dt):
    return None if s is None else s.to(dt)[:, None, None, None]


def _block_parts(x, params, heads, ws, shift, eps, scales):
    """The forward in rolled space, returning what the VJP needs."""
    (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2, bias) = params
    b, h, w, c = x.shape
    dt = x.dtype
    xr = torch.roll(x, (-shift, -shift), (1, 2)) if shift else x
    h1 = _layernorm(xr, ln1_s, ln1_b, eps)
    qkv = _matmul(h1, wqkv, bqkv)
    q, k, v = winattn.split_qkv(winattn.windows(qkv, ws), heads)
    mask = winattn._mask_tensor((h, w, ws, shift) if shift else None, x.device)
    p32 = winattn.attention_probs(q, k, bias, mask, None, False)
    att = winattn.unwindows(winattn.attention_out(p32, v), ws, b, h, w)
    s1, s2 = (None, None) if scales is None else (_scale(scales[0], dt), _scale(scales[1], dt))
    proj = _matmul(att, wproj, bproj)
    y = xr + (proj if s1 is None else proj * s1)
    h2 = _layernorm(y, ln2_s, ln2_b, eps)
    z1 = _matmul(h2, w1, b1)
    zg = _gelu(z1)
    mlp = _matmul(zg, w2, b2)
    out = y + (mlp if s2 is None else mlp * s2)
    return out, dict(xr=xr, h1=h1, q=q, k=k, v=v, p32=p32, att=att, y=y, h2=h2, z1=z1, zg=zg, s1=s1, s2=s2)


def reference_block(x, params, *, heads, ws, shift, eps, scales=None):
    """Plain PyTorch version of the forward kernel (any device).

    x: (B, H, W, C) float32 or bfloat16, canonical layout; ``params`` the
    13-tuple (ln1_s, ln1_b, W_qkv (C, 3C), b_qkv, W_proj (C, C), b_proj,
    ln2_s, ln2_b, W_fc1 (C, hidden), b_fc1, W_fc2 (hidden, C), b_fc2, the
    (heads, n, n) f32 bias map) with the attention scale already folded
    into W_qkv / b_qkv; ``shift`` 0 or the block's shift (masked);
    ``scales`` None or the (B,) keep-scales (s1, s2).  Returns (B, H, W, C)
    in x's dtype."""
    out, _ = _block_parts(x, params, heads, ws, shift, eps, scales)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def reference_block_bwd(x, params, g, *, heads, ws, shift, eps, scales=None):
    """Plain PyTorch version of the backward kernels (any device), with the
    rounding of ``_block_bwd_kernel``: the forward recomputed, every
    cotangent rounded to x's dtype where that kernel rounds it, the
    parameter gradients and the bias map's in f32.  Returns (dx, dln1_s,
    dln1_b, dW_qkv, db_qkv, dW_proj, db_proj, dln2_s, dln2_b, dW_fc1,
    db_fc1, dW_fc2, db_fc2, dbias)."""
    (ln1_s, ln1_b, wqkv, bqkv, wproj, bproj, ln2_s, ln2_b, w1, b1, w2, b2, bias) = params
    b, h, w, c = x.shape
    dt = x.dtype
    _, r = _block_parts(x, params, heads, ws, shift, eps, scales)
    s1, s2 = r["s1"], r["s2"]
    gr = g.to(dt)
    gr = torch.roll(gr, (-shift, -shift), (1, 2)) if shift else gr

    def colsum(t):
        return t.float().reshape(-1, t.shape[-1]).sum(dim=0)

    gmlp = gr if s2 is None else gr * s2
    dw2, db2 = _matmul_dw(r["zg"], gmlp), colsum(gmlp)
    dz1 = (_matmul_dx(gmlp, w2).float() * _dgelu(r["z1"])).to(dt)
    dw1, db1 = _matmul_dw(r["h2"], dz1), colsum(dz1)
    dy_ln, dln2_s, dln2_b = _layernorm_bwd(r["y"], ln2_s, eps, _matmul_dx(dz1, w1))
    dy1 = gr + dy_ln
    gproj = dy1 if s1 is None else dy1 * s1
    dwp, dbp = _matmul_dw(r["att"], gproj), colsum(gproj)
    datt = _matmul_dx(gproj, wproj)

    # attention: (Wn, heads, n, d) parts, the f32 probabilities p32
    q, k, v, p32 = r["q"], r["k"], r["v"], r["p32"]
    do = winattn.heads_of(winattn.windows(datt, ws), heads)
    p = p32.to(dt)
    dp = do.float() @ v.float().transpose(-1, -2)
    dv = (p.float().transpose(-1, -2) @ do.float()).to(dt)
    ds = p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))
    dbias = ds.sum(dim=0)
    ds_c = ds.to(dt).float()
    dq = (ds_c @ k.float()).to(dt)
    dk = (ds_c.transpose(-1, -2) @ q.float()).to(dt)
    dqkv_w = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(dq.shape[0], dq.shape[2], 3 * c)
    dqkv = winattn.unwindows(dqkv_w, ws, b, h, w)

    dwqkv, dbqkv = _matmul_dw(r["h1"], dqkv), colsum(dqkv)
    dx_ln, dln1_s, dln1_b = _layernorm_bwd(r["xr"], ln1_s, eps, _matmul_dx(dqkv, wqkv))
    dx = dy1 + dx_ln
    dx = torch.roll(dx, (shift, shift), (1, 2)) if shift else dx
    return (dx, dln1_s, dln1_b, dwqkv, dbqkv, dwp, dbp, dln2_s, dln2_b, dw1, db1, dw2, db2, dbias)


def errors(got, ref):
    """Errors of the forward output ``got`` against ``ref`` under
    :data:`TOLERANCE`: (max abs error, relative error, bound on the abs
    error), relative to max |ref|."""
    err = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return err, err / scale if scale else 0.0, TOLERANCE[ref.dtype] * scale


def bwd_errors(got, ref):
    """Errors of the 14 gradients ``got`` against ``ref`` under
    :data:`BWD_TOLERANCE` and the row-count bound of the parameter
    gradients: {"dx": (max abs error, relative error, bound), ...}."""
    tol = BWD_TOLERANCE[ref[0].dtype]
    sum_tol = 8 * (ref[0].numel() / ref[0].shape[-1]) ** 0.5 * 2.0**-23
    out = {}
    for name, g, r in zip(GRAD_NAMES, got, ref):
        err = (g.float() - r.float()).abs().max().item()
        scale = r.float().abs().max().item()
        bound = tol["dx"] if name == "dx" else max(tol["param"], sum_tol)
        out[name] = (err, err / scale if scale else 0.0, bound * scale)
    return out


def fits(c, hidden, heads, ws) -> bool:
    """Whether the kernels take a block of width c, MLP width hidden,
    ``heads`` heads and ws x ws windows."""
    return (c % heads == 0 and c <= MAX_C and hidden <= MAX_HIDDEN and ws * ws <= MAX_N
            and c // heads <= MAX_HEAD_DIM)


@functools.cache
def _fwd_fn():
    fn = cuda_build.load("swinblock").swin_block_fwd
    fn.argtypes = [ctypes.POINTER(_VOID_P)] + [_INT] * 9 + [_FLOAT, _VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _bwd_fn():
    fn = cuda_build.load("swinblock").swin_block_bwd
    fn.argtypes = [ctypes.POINTER(_VOID_P)] + [_INT] * 10 + [_FLOAT, _VOID_P]
    fn.restype = _INT
    return fn


def _ptrs(tensors):
    """A C array of the tensors' device pointers (None for a null one)."""
    return (_VOID_P * len(tensors))(*(None if t is None else t.data_ptr() for t in tensors))


def _check(x, params, heads, ws, scales):
    if x.device.type != "cuda":
        raise ValueError(f"fused_swin_block takes CPU or CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"fused_swin_block takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"fused_swin_block takes (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    hidden, n = params[8].shape[-1], ws * ws
    want = ((c,), (c,), (c, 3 * c), (3 * c,), (c, c), (c,), (c,), (c,), (c, hidden), (hidden,), (hidden, c), (c,),
            (heads, n, n))
    if tuple(tuple(p.shape) for p in params) != want:
        raise ValueError(
            f"parameters {[tuple(p.shape) for p in params]} do not fit x {tuple(x.shape)}: expected {list(want)}"
        )
    if h % ws or w % ws or c % heads:
        raise ValueError(f"fused_swin_block: {h}x{w} is no multiple of the window {ws}, or C {c} of heads {heads}")
    if not fits(c, hidden, heads, ws):
        raise ValueError(
            f"fused_swin_block takes C <= {MAX_C}, hidden <= {MAX_HIDDEN}, ws * ws <= {MAX_N} and head "
            f"dimension <= {MAX_HEAD_DIM}, got C {c}, hidden {hidden}, ws {ws}, head dimension {c // heads}"
        )
    tensors = list(params) + [s for s in (scales or ()) if s is not None]
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_swin_block: all inputs must be on x's device")
    if scales is not None and any(tuple(s.shape) != (b,) for s in scales):
        raise ValueError(f"keep-scales must be ({b},), got {[tuple(s.shape) for s in scales]}")


def _kernel_params(x, params):
    """The 12 matrices and vectors in x's dtype and the bias map in f32,
    contiguous, in the layouts the forward reads."""
    return tuple(p.detach().to(x.dtype).contiguous() for p in params[:12]) + (
        params[12].detach().float().contiguous(),)


def _kernel_scales(scales):
    return (None, None) if scales is None else tuple(s.detach().float().contiguous() for s in scales)


def _dims(x, params, heads, ws, shift):
    b, h, w, c = x.shape
    return [b, h, w, c, heads, ws, shift, params[8].shape[-1], _DTYPE_CODE[x.dtype]]


def _launch_fwd(x, params, heads, ws, shift, eps, scales=None):
    global launches
    _check(x, params, heads, ws, scales)
    kp = _kernel_params(x, params)
    s1, s2 = _kernel_scales(scales)
    x = x.contiguous()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fwd_fn()(
            _ptrs((x, out, *kp, s1, s2)), *_dims(x, params, heads, ws, shift), eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"swin_block_fwd launch failed with CUDA error {err}")
    launches += 1
    return out


# Blocks that the reduction launch aims to run (132 SMs x 8): the row
# reductions are split over grid.y until the grid holds about this many.
_REDUCE_TARGET_BLOCKS = 1056


def _splits(c, hidden, n_bias):
    """Row splits of the reduction launch: its 64 x 64 weight-gradient
    tiles and 256-column bias-map blocks, times the splits, make about
    ``_REDUCE_TARGET_BLOCKS`` blocks."""
    def t(v):
        return -(-v // 64)

    tiles = t(c) * t(3 * c) + t(c) * t(c) + t(c) * t(hidden) + t(hidden) * t(c) + -(-n_bias // 256)
    return max(1, min(65535, -(-_REDUCE_TARGET_BLOCKS // tiles)))


def _launch_bwd(x, params, gout, heads, ws, shift, eps, scales=None):
    """(dx, the 12 parameter gradients, dbias) by the two backward launches;
    the parameter gradients in f32."""
    global bwd_launches
    _check(x, params, heads, ws, scales)
    kp = _kernel_params(x, params)
    s1, s2 = _kernel_scales(scales)
    # the backward also reads W_qkv as (3C, C), W_proj^T, W_fc1 as (hidden, C), W_fc2 as (C, hidden)
    wt = tuple(kp[i].t().contiguous() for i in (2, 4, 8, 10))
    x = x.contiguous()
    gout = gout.to(x.dtype).contiguous()
    b, h, w, c = x.shape
    hidden, n = kp[8].shape[-1], ws * ws
    m, nwin = b * h * w, b * h * w // n
    dt = {"dtype": x.dtype, "device": x.device}
    f32 = {"dtype": torch.float32, "device": x.device}
    # scratch rows of the reduction launch, window by window: LN1(x), the
    # attention output, LN2(y), fc1's output and its GELU, the cotangents
    # of fc2, fc1, proj and qkv; the bias map's per-window gradients (f32)
    widths = (c, c, c, hidden, hidden, c, hidden, c, 3 * c)
    scratch = [torch.empty((m, wd), **dt) for wd in widths]
    ds = torch.empty((nwin, heads * n * n), **f32)
    dx = torch.empty_like(x)
    grads = [torch.zeros(p.shape, **f32) for p in kp]
    ptrs = _ptrs((x, gout, dx, *kp, *wt, s1, s2, *scratch, ds, *grads))
    with torch.cuda.device(x.device):
        err = _bwd_fn()(
            ptrs, *_dims(x, params, heads, ws, shift), _splits(c, hidden, heads * n * n), eps,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"swin_block_bwd launch failed with CUDA error {err}")
    bwd_launches += 2
    return (dx, *grads)


class _SwinBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s1, s2, cfg, *params):
        heads, ws, shift, eps = cfg
        scales = None if s1 is None else (s1, s2)
        if x.device.type == "cpu":
            out = reference_block(x, params, heads=heads, ws=ws, shift=shift, eps=eps, scales=scales)
        else:
            out = _launch_fwd(x, params, heads, ws, shift, eps, scales)
        ctx.save_for_backward(x, *params)
        ctx.cfg, ctx.scales = cfg, scales
        return out

    @staticmethod
    def backward(ctx, gout):
        x, *params = ctx.saved_tensors
        heads, ws, shift, eps = ctx.cfg
        if x.device.type == "cpu":
            grads = reference_block_bwd(x, params, gout, heads=heads, ws=ws, shift=shift, eps=eps,
                                        scales=ctx.scales)
        else:
            grads = _launch_bwd(x, params, gout, heads, ws, shift, eps, ctx.scales)
        dx, *dparams = grads
        return (dx, None, None, None, *(d.to(p.dtype) for d, p in zip(dparams, params)))


def fused_swin_block(x, params, *, heads, scale, ws, shift, eps, scales=None):
    """One whole Swin block on the canonical (B, H, W, C) tensor ``x``, by
    the CUDA kernels when x lies on a CUDA device; returns (B, H, W, C) in
    x's dtype.

    ``params``: the 13-tuple (ln1_s, ln1_b, W_qkv (C, 3C), b_qkv, W_proj,
    b_proj, ln2_s, ln2_b, W_fc1 (C, hidden), b_fc1, W_fc2, b_fc2, the
    (heads, n, n) f32 relative-position bias map); the attention ``scale``
    is folded into W_qkv and b_qkv here.  ``shift`` 0 or the block's
    shift, whose windows are masked.  ``scales``: None, or the (B,)
    DropPath keep-scales (s1, s2) of the attention and MLP branches, which
    get no gradient.  The parameters are cast to x's dtype inside, so their
    gradients come back in their own dtype (f32)."""
    params = _fold_scale(tuple(params), float(scale))
    s1, s2 = (None, None) if scales is None else scales
    return _SwinBlock.apply(x, s1, s2, (heads, ws, int(shift), float(eps)), *params)
