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

The kernels are ``csrc/swinblock.cu``, built by ``ops/cuda_build.py``, in
two routes that :func:`route` picks up front from the dtype and the shape:

- bfloat16 blocks with 8 x 8 windows, C a multiple of 16 up to 192, heads
  of 16 or 32 channels and an MLP width a multiple of 16 up to 384 run on
  the tensor cores (``csrc/swinblock_tc.cuh``, ``wgmma``): a window's 64
  tokens are the 64 rows of one product, one warpgroup owns a window, the
  weights stream through a ring of shared-memory slabs that a block's
  warpgroups share, and the attention and MLP intermediates stay in
  registers.  The forward is one launch; the backward two (the forward
  again and the chain back per window, with the bias map's gradient added
  in place; then the four weight gradients as split-K products over the
  scratch rows).  :func:`tc_plan` sizes the persistent grid.  The weights
  are read as the module holds them.
- float32, and every other bfloat16 shape, run on the CUDA cores in f32:
  the forward is one launch (one thread block per window, everything
  between x and the output on chip); the backward two (the per-window
  gradient chain, then the weight gradients' and the bias map's reductions
  over all rows and windows), which also read transposed copies of the
  four weights.

:func:`fused_swin_block` is a ``torch.autograd.Function``: for a CUDA
tensor its forward and backward launch those kernels; for a CPU tensor they
take :func:`reference_block` and :func:`reference_block_bwd`.  A CUDA
tensor never falls back to them, and a bfloat16 CUDA tensor on the
tensor-core route never to the CUDA-core kernels.
"""

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build, winattn
from .blockmath import _aligned, _dgelu, _gelu, _layernorm, _layernorm_bwd, _matmul, _matmul_dw, _matmul_dx

# Launches of the CUDA kernels in this process (the plain versions do not
# count): the forward adds 1 per call, the backward BWD_LAUNCHES[route] (its
# launches); tc_launches and tc_bwd_launches count those of the
# tensor-core route alone.
launches = 0
bwd_launches = 0
tc_launches = 0
tc_bwd_launches = 0
BWD_LAUNCHES = {"tc": 2, "cuda_core": 2}

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

# What csrc/swinblock_tc.cuh takes and how its shared memory is laid out
# (its smem_bytes): per warpgroup (window) two token tiles forward, three
# backward, of 64 tokens x C rounded up to 64 in bf16 (8 KB a 64-channel
# chunk), the 3C channels of q, k, v transposed (128 bytes a channel) and
# 2 KB of token statistics; a ring of `nring` weight slabs of one tile
# each; the backward's f32 column sums (9C + hidden, rounded up to 4); the
# slab table (40 bytes a slab); 1 KB of alignment slack.
TC_HEAD_DIMS = (16, 32)
SMEM_LIMIT = 232448
SMS = 132
_CHUNK = 8192
# csrc/swinblock_tc.cuh: MAX_SLABS, sizeof(Slab), STATS_BYTES
_MAX_SLABS, _SLAB_BYTES, _STATS_BYTES = 128, 40, 2048

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


def _cdiv(a, b):
    return -(-a // b)


def tc_smem(c, hidden, wg, nring, backward):
    """Dynamic shared memory of a tensor-core block (bytes): ``wg`` windows,
    ``nring`` weight slabs (csrc/swinblock_tc.cuh:smem_bytes)."""
    cs = _cdiv(c, 64)
    per_wg = (3 if backward else 2) * cs * _CHUNK + 3 * c * 128 + _STATS_BYTES
    sums = 4 * ((9 * c + hidden + 3) & ~3) if backward else 0
    return 1024 + nring * cs * _CHUNK + wg * per_wg + sums + tc_slabs(c, hidden, backward) * _SLAB_BYTES


def tc_slabs(c, hidden, backward):
    """The weight slabs a window's products take (csrc/swinblock_tc.cuh:
    slab_count): 64-row slabs of qkv and proj in N chunks of 64 ceil(C / 64)
    columns (backward 64), the MLP per 64-wide chunk of hidden, and
    backward dh2, datt and dh1 per such N chunk."""
    cs = _cdiv(c, 64)
    nw = 64 * (1 if backward else cs)
    halves, hc = _cdiv(c, nw), _cdiv(hidden, 64)
    fwd = _cdiv(3 * c, nw) * cs + halves * cs + hc * (2 * cs if backward else cs + 1)
    return fwd + (halves * (hc + cs + _cdiv(3 * c, 64)) if backward else 0)


@functools.cache
def tc_plan(nwin, c, hidden, backward):
    """The tensor-core launch of ``nwin`` windows: (wg, nring, grid, smem).

    Two windows a block (two warpgroups share each weight slab) where that
    still gives every SM a block, else one; three ring stages where they
    fit, else two.  The grid is persistent: block b takes the window groups
    b, b + grid, ..., at most one block an SM for two warpgroups (their
    registers fill it) and as many as fit for one (at most two)."""
    if tc_slabs(c, hidden, backward) > _MAX_SLABS:
        raise ValueError(f"C {c}, hidden {hidden}: more weight slabs than the kernel's table holds")
    for wg in (2, 1):
        for nring in (3, 2):
            smem = tc_smem(c, hidden, wg, nring, backward)
            if smem > SMEM_LIMIT:
                continue
            groups = _cdiv(nwin, wg)
            if wg == 2 and groups < SMS:
                break
            per_sm = min(2 // wg, 233472 // (smem + 1024))
            return wg, nring, min(groups, SMS * max(1, per_sm)), smem
    raise ValueError(f"no tensor-core tiling fits C {c}, hidden {hidden}")


@functools.cache
def route(c, hidden, heads, ws, dtype):
    """The route of a CUDA tensor's launches: ``"tc"`` (tensor cores) for
    bfloat16 with 8 x 8 windows, C a multiple of 16 up to MAX_C, heads of
    16 or 32 channels and hidden a multiple of 16 up to MAX_HIDDEN;
    ``"cuda_core"`` for every other shape and dtype."""
    ok = (dtype == torch.bfloat16 and ws * ws == MAX_N and c % 16 == 0 and c <= MAX_C and c % heads == 0
          and c // heads in TC_HEAD_DIMS and hidden % 16 == 0 and hidden <= MAX_HIDDEN)
    return "tc" if ok else "cuda_core"


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


@functools.cache
def _tc_fwd_fn():
    fn = cuda_build.load("swinblock").swin_tc_fwd
    fn.argtypes = [ctypes.POINTER(_VOID_P)] + [_INT] * 10 + [_FLOAT, _VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _tc_bwd_fn():
    fn = cuda_build.load("swinblock").swin_tc_bwd
    fn.argtypes = [ctypes.POINTER(_VOID_P)] + [_INT] * 11 + [_FLOAT, _VOID_P]
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
    contiguous and 16-byte aligned, in the layouts the forward reads."""
    return tuple(_aligned(p.detach().to(x.dtype)) for p in params[:12]) + (_aligned(params[12].detach().float()),)


def _kernel_scales(scales):
    return (None, None) if scales is None else tuple(s.detach().float().contiguous() for s in scales)


def _dims(x, params, heads, ws, shift):
    b, h, w, c = x.shape
    return [b, h, w, c, heads, ws, shift, params[8].shape[-1], _DTYPE_CODE[x.dtype]]


def _route_of(x, params, heads, ws):
    return route(x.shape[-1], params[8].shape[-1], heads, ws, x.dtype)


def _launch_fwd(x, params, heads, ws, shift, eps, scales=None):
    global launches, tc_launches
    _check(x, params, heads, ws, scales)
    kp = _kernel_params(x, params)
    s1, s2 = _kernel_scales(scales)
    x = _aligned(x)
    out = torch.empty_like(x)
    b, h, w, c = x.shape
    hidden = kp[8].shape[-1]
    tc = _route_of(x, params, heads, ws) == "tc"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if tc:
            wg, nring, grid, _ = tc_plan(b * h * w // 64, c, hidden, False)
            err = _tc_fwd_fn()(_ptrs((x, out, *kp, s1, s2)), b, h, w, c, heads, shift, hidden, wg, nring, grid, eps,
                               stream)
        else:
            err = _fwd_fn()(_ptrs((x, out, *kp, s1, s2)), *_dims(x, params, heads, ws, shift), eps, stream)
    if err != 0:
        raise RuntimeError(f"swin_{'tc' if tc else 'block'}_fwd launch failed with CUDA error {err}")
    launches += 1
    tc_launches += int(tc)
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


def tc_dw_rows(m, c, hidden):
    """Rows of a share of the tensor-core weight-gradient launch, a multiple
    of 64, for about eight of its 64 x 128 tile blocks an SM
    (``tools/swin_sweep.py`` put four, eight and 16 within 3% of each
    other at the default SwinIR's blocks, the fastest changing between
    runs)."""
    tiles = (_cdiv(c, 64) * _cdiv(3 * c, 128) + _cdiv(c, 64) * _cdiv(c, 128) + _cdiv(c, 64) * _cdiv(hidden, 128)
             + _cdiv(hidden, 64) * _cdiv(c, 128))
    return 64 * _cdiv(_cdiv(m, max(1, min(_cdiv(m, 64), _cdiv(8 * SMS, tiles)))), 64)


def _launch_bwd(x, params, gout, heads, ws, shift, eps, scales=None):
    """(dx, the 12 parameter gradients, dbias) by the backward launches of
    the route (BWD_LAUNCHES); the parameter gradients in f32."""
    global bwd_launches, tc_bwd_launches
    _check(x, params, heads, ws, scales)
    kp = _kernel_params(x, params)
    s1, s2 = _kernel_scales(scales)
    x = _aligned(x)
    gout = _aligned(gout.to(x.dtype))
    b, h, w, c = x.shape
    hidden, n = kp[8].shape[-1], ws * ws
    m, nwin = b * h * w, b * h * w // n
    dt = {"dtype": x.dtype, "device": x.device}
    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty_like(x)
    grads = [torch.zeros(p.shape, **f32) for p in kp]
    tc = _route_of(x, params, heads, ws) == "tc"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if tc:
            # scratch rows of the weight gradients, window by window: LN1(x),
            # the attention output, LN2(y), GELU(z1), the cotangents of fc2,
            # fc1, proj and qkv
            widths = (c, c, c, hidden, c, hidden, c, 3 * c)
            scratch = [torch.empty((m, wd), **dt) for wd in widths]
            wg, nring, grid, _ = tc_plan(nwin, c, hidden, True)
            err = _tc_bwd_fn()(
                _ptrs((x, gout, dx, *kp, s1, s2, *scratch, *grads)), b, h, w, c, heads, shift, hidden, wg, nring,
                grid, tc_dw_rows(m, c, hidden), eps, stream,
            )
        else:
            # the CUDA-core backward also reads W_qkv as (3C, C), W_proj^T,
            # W_fc1 as (hidden, C), W_fc2 as (C, hidden); its scratch rows, window
            # by window: LN1(x), the attention output, LN2(y), fc1's output and
            # its GELU, the cotangents of fc2, fc1, proj and qkv; the bias map's
            # per-window gradients (f32)
            wt = tuple(kp[i].t().contiguous() for i in (2, 4, 8, 10))
            widths = (c, c, c, hidden, hidden, c, hidden, c, 3 * c)
            scratch = [torch.empty((m, wd), **dt) for wd in widths]
            ds = torch.empty((nwin, heads * n * n), **f32)
            err = _bwd_fn()(
                _ptrs((x, gout, dx, *kp, *wt, s1, s2, *scratch, ds, *grads)), *_dims(x, params, heads, ws, shift),
                _splits(c, hidden, heads * n * n), eps, stream,
            )
    if err != 0:
        raise RuntimeError(f"swin_{'tc' if tc else 'block'}_bwd launch failed with CUDA error {err}")
    k = BWD_LAUNCHES["tc" if tc else "cuda_core"]
    bwd_launches += k
    tc_bwd_launches += k if tc else 0
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
