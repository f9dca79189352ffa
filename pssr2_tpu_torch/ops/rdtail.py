"""The RDNet block tail, LayerNorm -> fc1 (1x1) -> GELU -> fc2 (1x1), on
flattened rows, and its VJP.

Counterpart: pssr2_tpu/ops/pallas/rdtail.py (``fused_rd_tail`` at 253
with its custom VJP ``_tail_fn`` at 230, kernels ``_tail_kernel`` at 109
and ``_tail_bwd_kernel`` at 117, oracle ``reference_tail`` at 218).  The
GELU, LayerNorm and product helpers it shares with the Swin block are in
``ops/blockmath.py``.

The kernels are ``csrc/rdtail.cu``, built by ``ops/cuda_build.py``, in two
routes that :func:`route` picks up front from the dtype and the shape:

- bfloat16 rows whose C, inter and G are multiples of 8 (C <= TC_MAX_C,
  G <= MAX_G) run on the tensor cores (``csrc/rdtail_tc.cuh``, ``wgmma``):
  the forward is one launch, the two products back to back with the
  GELU intermediate in registers, I split over a thread-block cluster
  where the rows alone do not fill the card; the backward is four (the
  per-row chain, dh, the weight gradients, the LayerNorm backward).
  :func:`tail_plan` tiles both.  The bound is the operations,
  2 M inter (C + G) forward and 2 M inter (3C + 2G) backward, against
  989 TFLOP/s.
- float32, and every other bfloat16 shape, run on the CUDA cores in f32:
  the forward is one launch, the backward two (the per-row gradient chain,
  then the weight gradients' reduction over all rows).

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
    _aligned,
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
# count): the forward adds 1 per call, the backward BWD_LAUNCHES[route]
# (its launches); tc_launches and tc_bwd_launches count those of the
# tensor-core route alone.
launches = 0
bwd_launches = 0
tc_launches = 0
tc_bwd_launches = 0
BWD_LAUNCHES = {"tc": 4, "cuda_core": 2}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# What csrc/rdtail.cu takes.  Both routes keep the fc2 accumulators of a
# row tile in registers: G <= MAX_G.  The CUDA-core route holds the
# normalised rows of a tile in f32 in shared memory: C <= MAX_C.  The
# tensor-core route holds them in bf16 beside its ring of weight tiles, and
# its LayerNorm backward keeps a row in a warp's registers: C <= TC_MAX_C;
# a bf16 shape past it takes the CUDA-core route.
MAX_G = 256
MAX_C = 1408
TC_MAX_C = 1024

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


# The tensor-core route's tiling (csrc/rdtail_tc.cuh).  SMS: the H100's
# multiprocessors; SM_SMEM: the shared memory of one (a block reserves 1 KB
# more than it asks for); SMEM_LIMIT: what one block may use; MAX_SPLITS:
# the blocks of a thread-block cluster (the portable limit), over which
# the forward splits I; RING: the weight tiles of 64 K rows in flight.
SMS = 132
SM_SMEM = 233472
SMEM_LIMIT = 232448
MAX_SPLITS = 8
RING = 3
# The planner's model of the card (the cost only: a wrong guess here costs
# time, never a result).  GPC_SMS: multiprocessors of each GPC, where a
# cluster's blocks must run together.  An H100 SXM has 132 in 8 GPCs, cut
# differently from card to card; this split holds the one-wave limits that
# tools/rdtail_sweep.py measured at one block a multiprocessor (clusters of
# 2 x 64, 3 x 32, 6 x 16 and 8 x 8 in one wave; 4 x 32, 7 x 16 and 8 x 16
# not).  REGS: registers a thread of each kernel (ptxas -v, CUDA 12.8):
# forward by (ni, gp), rows by ni.
GPC_SMS = (18, 18, 18, 18, 18, 18, 12, 12)
REGS = {"fwd": {(128, 64): 168, (128, 128): 192, (64, 256): 232}, "rows": {64: 128, 128: 200}}
# The cost of a wave: a multiprocessor's resident warpgroups hide each
# other's latency up to OVERLAP of them; a block of two warpgroups, in step
# at every barrier, costs WG2_COST of two blocks of one; a block's
# LayerNorm and start BLOCK_COST I chunks of 64 columns (fitted to the
# same sweep).
OVERLAP = 2.5
WG2_COST = 0.97
BLOCK_COST = 0.5


def _cdiv(a, b):
    return -(-a // b)


def _gp(g):
    """G rounded up to the fc2 product's width: 64, 128 or 256."""
    return 64 if g <= 64 else 128 if g <= 128 else 256


def fwd_smem(wg, ni, gp, kp):
    """Shared memory of the forward block (FwdCfg::bytes): the ring of
    64-row weight tiles and the bf16 row tile (64 wg rows x kp channels),
    or the f32 partial sums of fc2 where the cluster meets, if larger."""
    bm = 64 * wg
    return max(RING * 64 * max(ni, gp) * 2 + bm * kp * 2, bm * (gp + 4) * 4) + 1024


def rows_smem(wg, ni, kp, gk):
    """Shared memory of the backward's rows block (RowsCfg::bytes): the
    ring, the row tile and the cotangent tile in bf16, the db1 sums."""
    bm = 64 * wg
    return RING * ni * 128 + bm * (kp + gk) * 2 + 4 * wg * ni * 4 + 1024


def split_range(y, n, splits):
    """The chunks [lo, hi) of share y of n chunks in ``splits`` shares
    (csrc/rdtail_tc.cuh:split_range): none empty while splits <= n."""
    return y * n // splits, (y + 1) * n // splits


def per_sm(smem, regs, wg):
    """Blocks of a kernel that one multiprocessor holds at once."""
    return max(0, min(SM_SMEM // (smem + 1024), 65536 // (regs * 128 * wg)))


def wave(bps, splits):
    """Blocks that run at once with ``bps`` a multiprocessor: a cluster of
    ``splits`` blocks runs on ``splits`` multiprocessors of one GPC."""
    if splits == 1:
        return SMS * bps
    return bps * splits * sum(n // splits for n in GPC_SMS)


def grid_cost(tiles, splits, chunks, bps, wg, units, cluster):
    """Modelled time of a grid of tiles x splits blocks of ``wg``
    warpgroups, each of ceil(chunks / splits) I chunks of ``units``
    64-column units, ``bps`` blocks a multiprocessor, the splits of a tile
    one cluster or not: wave by wave, the busiest multiprocessor's
    warpgroups share it, OVERLAP at a time."""
    blocks, per_wave = tiles * splits, wave(bps, splits if cluster else 1)
    if per_wave == 0:
        return float("inf")
    work = _cdiv(chunks, splits) * units + BLOCK_COST
    cost = 0.0
    while blocks > 0:
        resident = wg * min(bps, _cdiv(min(blocks, per_wave), SMS))
        cost += work * max(resident, OVERLAP) / OVERLAP * (WG2_COST if wg == 2 else 1.0)
        blocks -= per_wave
    return cost


def _best(candidates):
    """The candidate (cost, blocks, config) of least cost; of equal costs
    the one with most blocks."""
    return min(candidates, key=lambda t: (t[0], -t[1]))[2]


@functools.cache
def tail_plan(m, c, inter, g):
    """Tiling of the tensor-core route at (M, C, inter, G), a dict:

    - ``fwd``: (wg, ni, splits, smem): wg warpgroups of 64 rows a block,
      I in chunks of ni (128, or 64 where G > 128 leaves fewer registers)
      and grid.y ``splits`` shares of the chunks, one cluster, at most
      MAX_SPLITS, clusters in one wave: of the configurations that fit,
      the one of least :func:`grid_cost`;
    - ``rows``: (wg, ni, splits, smem) of the backward's first launch, as
      the forward's but with no cluster: up to one share a chunk;
    - ``dh_bn``: channels of a dh block: 128 where that grid still fills
      the card and pads C no further than 64 would, else 64;
    - ``dw_rows``: rows of a share of the weight-gradient reduction, a
      multiple of 64, for about four 64 x 128 tile blocks an SM."""
    kp, gk, gp = 64 * _cdiv(c, 64), 64 * _cdiv(g, 64), _gp(g)
    ni = 128 if gp <= 128 else 64
    fwd = []
    for wg in (1, 2):
        smem = fwd_smem(wg, ni, gp, kp)
        if smem > SMEM_LIMIT:
            continue
        tiles, bps = _cdiv(m, 64 * wg), per_sm(smem, REGS["fwd"][ni, gp], wg)
        for splits in range(1, min(MAX_SPLITS, _cdiv(inter, ni)) + 1):
            if splits > 1 and tiles * splits > wave(bps, splits):
                continue  # clusters only in one wave: a chip run found later waves of clusters slow
            cost = grid_cost(tiles, splits, _cdiv(inter, ni), bps, wg, ni // 64, True)
            fwd.append((cost, tiles * splits, (wg, ni, splits, smem)))
    rows = []
    for wg in (1, 2):
        for r_ni in (64, 128):
            smem = rows_smem(wg, r_ni, kp, gk)
            if smem > SMEM_LIMIT:
                continue
            tiles, bps = _cdiv(m, 64 * wg), per_sm(smem, REGS["rows"][r_ni], wg)
            for splits in range(1, min(64, _cdiv(inter, r_ni)) + 1):
                cost = grid_cost(tiles, splits, _cdiv(inter, r_ni), bps, wg, r_ni // 64, False)
                rows.append((cost, tiles * splits, (wg, r_ni, splits, smem)))
    fills = _cdiv(m, 64) * _cdiv(c, 128) >= SMS
    dh_bn = 128 if fills and 128 * _cdiv(c, 128) == 64 * _cdiv(c, 64) else 64
    tiles = _cdiv(c, 64) * _cdiv(inter, 128) + _cdiv(inter, 64) * _cdiv(g, 128)
    dw_rows = 64 * _cdiv(_cdiv(m, max(1, min(_cdiv(m, 64), _cdiv(4 * SMS, tiles)))), 64)
    return {"fwd": _best(fwd), "rows": _best(rows), "dh_bn": dh_bn, "dw_rows": dw_rows}


@functools.cache
def route(c, inter, g, dtype):
    """The route of a CUDA tensor's launches: ``"tc"`` (tensor cores) for
    bfloat16 with C, inter and G multiples of 8, C <= TC_MAX_C, G <= MAX_G
    and both row blocks (one warpgroup) in shared memory; ``"cuda_core"``
    for every other shape and dtype."""
    if dtype != torch.bfloat16 or c % 8 or inter % 8 or g % 8 or c > TC_MAX_C or g > MAX_G:
        return "cuda_core"
    kp, gk, gp = 64 * _cdiv(c, 64), 64 * _cdiv(g, 64), _gp(g)
    fits = fwd_smem(1, 128 if gp <= 128 else 64, gp, kp) <= SMEM_LIMIT and rows_smem(1, 64, kp, gk) <= SMEM_LIMIT
    return "tc" if fits else "cuda_core"



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


@functools.cache
def _tc_fwd_fn():
    fn = cuda_build.load("rdtail").rdtail_tc_fwd
    fn.argtypes = [_VOID_P] * 8 + [_INT] * 7 + [_FLOAT, _VOID_P]
    fn.restype = _INT
    return fn


@functools.cache
def _tc_bwd_fn():
    fn = cuda_build.load("rdtail").rdtail_tc_bwd
    fn.argtypes = [_VOID_P] * 18 + [_INT] * 9 + [_FLOAT, _VOID_P]
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
    return tuple(_aligned(p.detach().to(x.dtype)) for p in params)


def _launch_fwd(x, params, eps):
    global launches, tc_launches
    m, c = x.shape
    inter, g = params[2].shape[-1], params[4].shape[-1]
    lns, lnb, w1, b1, w2, b2 = _kernel_params(x, params)
    x = _aligned(x)
    out = torch.empty((m, g), dtype=x.dtype, device=x.device)
    ptrs = (x, lns, lnb, w1, b1, w2, b2, out)
    tc = route(c, inter, g, x.dtype) == "tc"
    with torch.cuda.device(x.device):
        if tc:
            wg, ni, splits, _ = tail_plan(m, c, inter, g)["fwd"]
            err = _tc_fwd_fn()(*(t.data_ptr() for t in ptrs), m, c, inter, g, wg, ni, splits, eps, _stream(x.device))
        else:
            err = _fwd_fn()(*(t.data_ptr() for t in ptrs), m, c, inter, g, _DTYPE_CODE[x.dtype], eps,
                            _stream(x.device))
    if err != 0:
        raise RuntimeError(f"rdtail_{'tc_' if tc else ''}fwd launch failed with CUDA error {err}")
    launches += 1
    tc_launches += int(tc)
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
    """(dx, dlns, dlnb, dw1, db1, dw2, db2) by the backward launches of the
    route (BWD_LAUNCHES); the parameter gradients in f32."""
    global bwd_launches, tc_bwd_launches
    m, c = x.shape
    inter, g = params[2].shape[-1], params[4].shape[-1]
    lns, lnb, w1, b1, w2, _ = _kernel_params(x, params)
    x = _aligned(x)
    gout = _aligned(gout.to(x.dtype))
    dt = {"dtype": x.dtype, "device": x.device}
    f32 = {"dtype": torch.float32, "device": x.device}
    # scratch: the normalised rows, GELU(z1) and dz1 (and, on the tensor
    # cores, dh) in x's dtype
    h, zg, dz1 = torch.empty((m, c), **dt), torch.empty((m, inter), **dt), torch.empty((m, inter), **dt)
    dx = torch.empty_like(x)
    dlns, dlnb, db1, db2 = (torch.zeros(n, **f32) for n in (c, c, inter, g))
    dw1, dw2 = torch.zeros((c, inter), **f32), torch.zeros((inter, g), **f32)
    grads = (dx, dlns, dlnb, dw1, db1, dw2, db2)
    tc = route(c, inter, g, x.dtype) == "tc"
    with torch.cuda.device(x.device):
        if tc:
            plan = tail_plan(m, c, inter, g)
            rows_wg, rows_ni, rows_splits, _ = plan["rows"]
            dh = torch.empty((m, c), **dt)
            ptrs = (x, lns, lnb, w1, b1, w2, gout, h, zg, dz1, dh, dx, dlns, dlnb, dw1, db1, dw2, db2)
            err = _tc_bwd_fn()(
                *(t.data_ptr() for t in ptrs), m, c, inter, g, rows_wg, rows_ni, rows_splits, plan["dh_bn"],
                plan["dw_rows"], eps, _stream(x.device),
            )
        else:
            # the CUDA-core backward also reads fc1 as (inter, C) and fc2 as (G, inter)
            w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
            ptrs = (x, lns, lnb, w1, w1t, b1, w2t, gout, h, zg, dz1, dx, dlns, dlnb, dw1, db1, dw2, db2)
            err = _bwd_fn()(
                *(t.data_ptr() for t in ptrs),
                m, c, inter, g, _DTYPE_CODE[x.dtype], _dw_splits(m, c, inter, g), eps, _stream(x.device),
            )
    if err != 0:
        raise RuntimeError(f"rdtail_{'tc_' if tc else ''}bwd launch failed with CUDA error {err}")
    n = BWD_LAUNCHES["tc" if tc else "cuda_core"]
    bwd_launches += n
    tc_bwd_launches += n if tc else 0
    return grads


class _FusedTail(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lns, lnb, w1, b1, w2, b2, eps):
        params = (lns, lnb, w1, b1, w2, b2)
        if x.device.type == "cpu":
            out = reference_tail(x, *params, eps=eps)
        else:
            _check(x, params)
            # the kernels' copies of the parameters, kept for the backward
            params = _kernel_params(x, params)
            out = _launch_fwd(x, params, eps)
        ctx.save_for_backward(x, *params)
        ctx.eps = eps
        ctx.dtypes = (lns.dtype, lnb.dtype, w1.dtype, b1.dtype, w2.dtype, b2.dtype)
        return out

    @staticmethod
    def backward(ctx, gout):
        x, *params = ctx.saved_tensors
        if x.device.type == "cpu":
            grads = reference_tail_bwd(x, *params, gout, eps=ctx.eps)
        else:
            grads = _launch_bwd(x, params, gout, ctx.eps)
        dx, *dparams = grads
        return (dx, *(d.to(dt) for d, dt in zip(dparams, ctx.dtypes)), None)


def fused_rd_tail(x, lns, lnb, w1, b1, w2, b2, *, eps):
    """LayerNorm -> fc1 -> GELU -> fc2 on rows ``x`` (M, C), by the CUDA
    kernels when ``x`` lies on a CUDA device; returns (M, G) in x's dtype.
    The parameters are cast to x's dtype inside, so their gradients come
    back in their own dtype (f32), as ``_tail_fn`` returns them."""
    return _FusedTail.apply(x, lns, lnb, w1, b1, w2, b2, float(eps))
