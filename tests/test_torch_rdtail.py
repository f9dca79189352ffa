"""The port's RDNet block tail (pssr2_tpu_torch/ops/rdtail.py) against the
JAX package's (pssr2_tpu/ops/pallas/rdtail.py), on the CPU.

The plain versions ``reference_tail`` and ``reference_tail_bwd`` are held
against JAX's ``reference_tail`` (and its ``jax.vjp``) and against the
Pallas kernel run in interpret mode (``fused_rd_tail`` with ``MODE =
"interpret"``, and its custom VJP), in f32 and bf16, at the JAX tests'
shape and at one whose sizes are no multiples of 8.

Tolerances.  f32: 2e-6 on the outputs (of magnitude about 1) and 3e-5 of
the largest element of each gradient, those of tests/test_rdtail.py: only
the order of f32 sums differs.  bf16: the two packages round the same
values to bf16 at the same places, so most elements agree exactly; an f32
sum taken in another order can move a rounding by one bf16 ulp, so the
outputs and dx get 2 bf16 ulps (1/64) of their largest element, the f32
parameter gradients (sums of bf16 terms) 1 bf16 ulp (1/256), and the
mean error stays below 1/1000 of the largest.  Against JAX's
``reference_tail`` at most 1% of the bf16 outputs may differ at all; the
interpreted kernel differs from that reference itself by one bf16 ulp in
many more (its dots round otherwise in interpret mode).

The bf16 tensor-core route's host side is checked here too (its kernels
run only on the card, in tests/test_torch_cuda_kernels.py): ``tail_plan``
at the 21 tails of the full-width RDResUNet() at batch 16 and at ragged
shapes, and the route each shape and dtype takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.ops.pallas import rdtail as jrdtail
from pssr2_tpu_torch.ops import rdtail

torch.set_num_threads(2)

EPS = 1e-6
# (M, C, inter, G): tests/test_rdtail.py's shape, and one of no multiples of 8
SHAPES = [(256, 48, 192, 24), (100, 37, 75, 13)]


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jrdtail.MODE
    jrdtail.MODE = "interpret"
    yield
    jrdtail.MODE = old


def _inputs(shape, seed):
    m, c, inter, g = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=0.1: (rng.standard_normal(s) * sc).astype(np.float32)
    x = rng.standard_normal((m, c)).astype(np.float32)
    params = (mk(c, sc=0.5) + 1.0, mk(c), mk(c, inter), mk(inter), mk(inter, g), mk(g))
    gout = rng.standard_normal((m, g)).astype(np.float32)
    return x, params, gout


def _params_t(params):
    return [torch.from_numpy(p) for p in params]


def _jax(a, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == "bf16" else jnp.float32)


def _torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


def _close(got, ref, dtype, kind, name=""):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    scale = max(1e-3, float(np.abs(ref).max()))
    err = np.abs(got - ref)
    if dtype == "f32":
        bound = 2e-6 if kind == "out" else 3e-5 * scale
    else:
        bound = (1 / 64 if kind in ("out", "dx") else 1 / 256) * scale
        assert err.mean() <= 1e-3 * scale, (name, err.mean(), scale)
    assert err.max() <= bound, (name, err.max(), bound)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_tail_matches_jax(shape, dtype):
    x, params, _ = _inputs(shape, 0)
    xj, xt = _jax(x, dtype), _torch(x, dtype)
    pj = tuple(jnp.asarray(p) for p in params)
    pt = tuple(torch.from_numpy(p) for p in params)
    out = rdtail.reference_tail(xt, *pt, eps=EPS)
    assert out.dtype == xt.dtype and out.shape == (shape[0], shape[3])
    ref = jrdtail.reference_tail(xj, *pj, eps=EPS)
    _close(out.float().numpy(), ref, dtype, "out")
    assert (out.float().numpy() != np.asarray(ref, np.float32)).mean() <= (0.01 if dtype == "bf16" else 1.0)
    _close(out.float().numpy(), jrdtail.fused_rd_tail(xj, *pj, eps=EPS), dtype, "out")


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_reference_tail_bwd_matches_jax(shape, dtype):
    """reference_tail_bwd against jax.vjp of the interpreted kernel (its
    custom VJP, ``_tail_bwd_kernel``) and of JAX's reference_tail."""
    x, params, gout = _inputs(shape, 1)
    xj, gj = _jax(x, dtype), _jax(gout, dtype)
    pj = tuple(jnp.asarray(p) for p in params)
    grads = rdtail.reference_tail_bwd(
        _torch(x, dtype), *(torch.from_numpy(p) for p in params), _torch(gout, dtype), eps=EPS
    )
    assert grads[0].dtype == (torch.bfloat16 if dtype == "bf16" else torch.float32)
    assert all(g.dtype == torch.float32 for g in grads[1:])
    fns = [jrdtail.fused_rd_tail]
    if dtype == "f32":
        # XLA's autodiff of the reference rounds elsewhere in bf16 (its
        # GELU derivative is of the rounded polynomial), so only f32 here
        fns.append(jrdtail.reference_tail)
    for fn in fns:
        _, vjp = jax.vjp(lambda x_, *p: fn(x_, *p, eps=EPS), xj, *pj)
        for name, got, ref in zip(rdtail.GRAD_NAMES, grads, vjp(gj)):
            _close(got.float().numpy(), ref, dtype, "dx" if name == "dx" else "param", name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fused_rd_tail_cpu_autograd(dtype):
    """On CPU tensors fused_rd_tail runs the plain versions under autograd,
    launches nothing, and gives the parameters' gradients in f32."""
    shape = SHAPES[1]
    x, params, gout = _inputs(shape, 2)
    xt = _torch(x, dtype).requires_grad_()
    pt = [torch.from_numpy(p).requires_grad_() for p in params]
    before = (rdtail.launches, rdtail.bwd_launches)
    out = rdtail.fused_rd_tail(xt, *pt, eps=EPS)
    np.testing.assert_array_equal(
        out.detach().float().numpy(), rdtail.reference_tail(xt.detach(), *_params_t(params), eps=EPS).float().numpy()
    )
    out.backward(_torch(gout, dtype))
    ref = rdtail.reference_tail_bwd(xt.detach(), *_params_t(params), _torch(gout, dtype), eps=EPS)
    for name, t, r in zip(rdtail.GRAD_NAMES, [xt, *pt], ref):
        assert t.grad.dtype == t.dtype, name
        np.testing.assert_array_equal(t.grad.float().numpy(), r.float().numpy(), err_msg=name)
    assert (rdtail.launches, rdtail.bwd_launches) == before


def test_gelus_match_jax():
    """The four GELU helpers against swinblock's, on both sides of the
    polynomial's [-4, 4] range, in f32 (bit for bit up to 1 f32 ulp)."""
    from pssr2_tpu.ops.pallas import swinblock

    z = np.linspace(-6, 6, 2401, dtype=np.float32)
    for ours, theirs in ((rdtail._gelu_exact, swinblock._gelu_exact), (rdtail._gelu_fast, swinblock._gelu_fast),
                         (rdtail._dgelu_exact, swinblock._dgelu_exact), (rdtail._dgelu_fast, swinblock._dgelu_fast)):
        got = ours(torch.from_numpy(z)).numpy()
        ref = np.asarray(theirs(jnp.asarray(z)))
        np.testing.assert_allclose(got, ref, rtol=2e-7, atol=2e-7, err_msg=ours.__name__)


def test_errors_helpers_bound_by_dtype():
    """errors / bwd_errors: zero against themselves; bounds as documented."""
    x, params, gout = _inputs(SHAPES[1], 3)
    xt, pt = _torch(x, "bf16"), _params_t(params)
    out = rdtail.reference_tail(xt, *pt, eps=EPS)
    err, rel, bound = rdtail.errors(out, out)
    assert err == rel == 0.0 and bound == pytest.approx(out.float().abs().max().item() / 64)
    grads = rdtail.reference_tail_bwd(xt, *pt, _torch(gout, "bf16"), eps=EPS)
    errs = rdtail.bwd_errors(grads, grads)
    assert list(errs) == list(rdtail.GRAD_NAMES) and all(e == 0.0 for e, _, _ in errs.values())


def _rdresunet_tails(batch=16, lr_res=128):
    """(M, C, inter, G) of the 21 dense-block tails of the full-width
    RDResUNet() x4 at ``batch`` (the port's model on the meta device)."""
    from pssr2_tpu_torch.models import RDResUNet

    model = RDResUNet(device="meta")
    res, tails = lr_res // model.ratios[-1], []
    for i, stage in enumerate(model.encoder.dense_stages):
        res //= 2 if model.encoder.ds_blocks[i] else 1
        for block in stage[-1].children():
            layers = block.layers.layers
            tails.append((batch * res * res, layers[0].in_channels, layers[2].out_channels, layers[4].out_channels))
    return tails


RD_TAILS = _rdresunet_tails()
# ragged shapes of the tensor-core route: M no multiple of 64, C no multiple
# of 16 or 64, G no multiple of 64, a single row, and C at TC_MAX_C
RAGGED = [(100, 40, 160, 24), (1000, 264, 1056, 104), (1, 8, 8, 8), (4160, 232, 928, 128), (2049, 1024, 4096, 256),
          (77, 616, 2464, 224), (130000, 128, 512, 64)]


def test_rdresunet_tails():
    assert len(RD_TAILS) == 21 and RD_TAILS[0] == (65536, 128, 512, 64) and RD_TAILS[-1] == (1024, 816, 3264, 224)


def _blocks(m, inter, wg, ni, splits):
    """[((row_lo, row_hi), (col_lo, col_hi))]: the rows and I columns of each
    block of a forward or rows grid (wg, ni, splits), as the kernels cut it
    (block x: 64 wg rows; block y: the chunks of rdtail.split_range)."""
    n = -(-inter // ni)
    return [((bx * 64 * wg, min(m, (bx + 1) * 64 * wg)),
             (rdtail.split_range(by, n, splits)[0] * ni, min(inter, rdtail.split_range(by, n, splits)[1] * ni)))
            for bx in range(-(-m // (64 * wg))) for by in range(splits)]


@pytest.mark.parametrize("shape", RD_TAILS + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_tail_plan_covers_each_row_and_column_once(shape):
    """The forward's and the backward rows kernel's blocks cover every row
    and every I column exactly once, every block some of each."""
    m, c, inter, g = shape
    plan = rdtail.tail_plan(*shape)
    for wg, ni, splits, _ in (plan["fwd"], plan["rows"]):
        cols = {}  # row range -> the column ranges of its blocks
        for rows, (c0, c1) in _blocks(m, inter, wg, ni, splits):
            assert rows[0] < rows[1] and c0 < c1 and c0 % ni == 0
            cols.setdefault(rows, []).append((c0, c1))
        edges = sorted(cols)
        assert edges[0][0] == 0 and edges[-1][1] == m and all(a[1] == b[0] for a, b in zip(edges, edges[1:]))
        for ranges in cols.values():
            ranges.sort()
            assert ranges[0][0] == 0 and ranges[-1][1] == inter
            assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert plan["dw_rows"] % 64 == 0 and plan["dw_rows"] > 0 and plan["dh_bn"] in (64, 128)


def _first_wave(kind, shape, wg, ni, splits):
    """(warpgroups with rows in the first wave, whether the grid is one wave) of the
    forward's or rows kernel's grid (wg, ni, splits) at ``shape``, by the
    planner's model of the card; None where the block does not fit or the
    forward's clusters would take more than one wave."""
    m, c, inter, g = shape
    kp, gk, gp = 64 * -(-c // 64), 64 * -(-g // 64), rdtail._gp(g)
    if kind == "fwd":
        smem, regs = rdtail.fwd_smem(wg, ni, gp, kp), rdtail.REGS["fwd"][ni, gp]
    else:
        smem, regs = rdtail.rows_smem(wg, ni, kp, gk), rdtail.REGS["rows"][ni]
    bps = rdtail.per_sm(smem, regs, wg)
    if smem > rdtail.SMEM_LIMIT or bps == 0:
        return None
    blocks, cap = -(-m // (64 * wg)) * splits, rdtail.wave(bps, splits if kind == "fwd" else 1)
    if kind == "fwd" and splits > 1 and blocks > cap:
        return None
    return min(-(-m // 64) * splits, wg * cap), blocks <= cap  # warpgroups with rows


@pytest.mark.parametrize("shape", RD_TAILS + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_tail_plan_fits_and_fills_the_card(shape):
    """Each block's shared memory stays within the H100's 232,448 bytes (the
    forward's also holds its f32 partial sums), and the forward and rows
    grids put >= 132 warpgroups on the card in their first wave, or as many
    as any one-wave grid of the shape could (the forward's clusters must
    run in one wave: a chip run found clusters past a wave slow)."""
    m, c, inter, g = shape
    plan = rdtail.tail_plan(*shape)
    kp, gk, gp = 64 * -(-c // 64), 64 * -(-g // 64), rdtail._gp(g)
    wg, ni, splits, smem = plan["fwd"]
    assert wg in (1, 2) and ni == (128 if gp <= 128 else 64) and 1 <= splits <= rdtail.MAX_SPLITS
    assert smem == rdtail.fwd_smem(wg, ni, gp, kp) <= rdtail.SMEM_LIMIT
    assert smem - 1024 >= 64 * wg * (gp + 4) * 4
    r_wg, r_ni, r_splits, r_smem = plan["rows"]
    assert r_wg in (1, 2) and r_ni in (64, 128) and r_splits <= -(-inter // r_ni)
    assert r_smem == rdtail.rows_smem(r_wg, r_ni, kp, gk) <= rdtail.SMEM_LIMIT
    for kind, (k_wg, k_ni, k_splits, _) in (("fwd", plan["fwd"]), ("rows", plan["rows"])):
        wgs, _ = _first_wave(kind, shape, k_wg, k_ni, k_splits)
        one_wave = []
        for cand_wg in (1, 2):
            for cand_ni in ((ni,) if kind == "fwd" else (64, 128)):
                cap = rdtail.MAX_SPLITS if kind == "fwd" else 64
                for cand_splits in range(1, min(cap, -(-inter // cand_ni)) + 1):
                    got = _first_wave(kind, shape, cand_wg, cand_ni, cand_splits)
                    if got is not None and got[1]:
                        one_wave.append(got[0])
        assert wgs >= min(rdtail.SMS, max(one_wave, default=0)), (kind, wgs, max(one_wave, default=0))


def test_route_selection():
    """Tensor cores for every RDResUNet tail in bf16, never in f32; the
    CUDA cores for C, inter or G no multiple of 8 and for C past
    TC_MAX_C."""
    for m, c, inter, g in RD_TAILS:
        assert rdtail.route(c, inter, g, torch.bfloat16) == "tc"
        assert rdtail.route(c, inter, g, torch.float32) == "cuda_core"
    for c, inter, g in ((37, 75, 13), (36, 160, 24), (40, 164, 24), (40, 160, 20), (rdtail.TC_MAX_C + 8, 160, 64),
                        (rdtail.MAX_C, 160, rdtail.MAX_G)):
        assert rdtail.route(c, inter, g, torch.bfloat16) == "cuda_core", (c, inter, g)
    assert rdtail.route(rdtail.TC_MAX_C, 4 * rdtail.TC_MAX_C, rdtail.MAX_G, torch.bfloat16) == "tc"
    assert rdtail.BWD_LAUNCHES == {"tc": 4, "cuda_core": 2}
