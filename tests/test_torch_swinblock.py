"""The port's whole Swin block (pssr2_tpu_torch/ops/swinblock.py) against
the JAX package's (pssr2_tpu/ops/pallas/swinblock.py), on the CPU.

The plain versions ``reference_block`` and ``reference_block_bwd`` (reached
through ``fused_swin_block``, as the model calls it) are held against the
Pallas kernel run in interpret mode (``swinblock.MODE = "interpret"``, as
tests/test_swinblock.py runs it: ``fused_swin_block`` and the custom VJP of
``fused_swin_block_train``) and against JAX's ``reference_block`` and its
``jax.vjp``, at C 96, 6 heads, 8 x 8 windows, in f32 and bf16.

Layouts.  The JAX block takes its input at roll offset v_in and gives its
output at offset ``shift``; the port's takes and gives the canonical
layout.  With delta = (shift - v_in) mod ws, the port's input is
roll(x_jax, shift - delta) and its output is compared with roll(jax_out,
shift).

Tolerances are JAX's own (tests/test_swinblock.py).  Forward: f32 2e-5
absolute (outputs of magnitude up to 8); bf16 0.02 of the largest output,
and against the interpreted kernel, whose rounding the port follows, two
bf16 ulps of the largest (1/64: an f32 sum taken in another order moves a
rounding by one ulp, and an early one moves the later ones; measured
1/103).  Gradients: f32 rtol and atol 2e-4; bf16
within 0.05 of the largest gradient against ``reference_block`` (dx, as
JAX's test), and against the interpreted kernel dx within 1/32 and every
parameter gradient within 1/128 of its largest element (measured: 0.011
and 0.0025).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.models.swinir import _shift_attn_mask as jax_shift_attn_mask
from pssr2_tpu.ops.pallas import swinblock as jswinblock
from pssr2_tpu_torch.ops import swinblock, winattn

torch.set_num_threads(2)

HEADS, WS, C, HIDDEN = 6, 8, 96, 192
N = WS * WS
SCALE = (C // HEADS) ** -0.5
EPS = 1e-6
CASES = [(0, 0, False), (4, 4, True), (4, 0, False)]  # (delta, shift, masked)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jswinblock.MODE
    jswinblock.MODE = "interpret"
    yield
    jswinblock.MODE = old


def _params(rng):
    mk = lambda *s, sc=0.1: (rng.standard_normal(s) * sc).astype(np.float32)
    return (mk(C, sc=0.5) + 1.0, mk(C), mk(C, 3 * C), mk(3 * C), mk(C, C), mk(C), mk(C, sc=0.5) + 1.0, mk(C),
            mk(C, HIDDEN), mk(HIDDEN), mk(HIDDEN, C), mk(C), (rng.standard_normal((HEADS, N, N)) * 0.02).astype(np.float32))


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bf16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _kw(delta, shift, masked, hw):
    return dict(heads=HEADS, scale=SCALE, ws=WS, delta=delta, shift=shift, mask_hw=(hw, hw) if masked else None,
                eps=EPS)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("delta,shift,masked", CASES)
def test_block_forward_matches_jax(delta, shift, masked, dtype):
    rng = np.random.default_rng(10 * delta + shift)
    x = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    params = _params(rng)
    kw = _kw(delta, shift, masked, 16)
    xj, pj = jnp.asarray(x, _jdt(dtype)), tuple(jnp.asarray(p) for p in params)
    fused = np.roll(np.asarray(jswinblock.fused_swin_block(xj, pj, **kw), np.float32), (shift, shift), (1, 2))
    ref = np.roll(np.asarray(jswinblock.reference_block(xj, pj, **kw), np.float32), (shift, shift), (1, 2))
    xt = torch.roll(torch.from_numpy(x).to(_tdt(dtype)), (shift - delta,) * 2, (1, 2))
    out = swinblock.fused_swin_block(xt, [torch.from_numpy(p) for p in params], heads=HEADS, scale=SCALE, ws=WS,
                                     shift=shift, eps=EPS)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    out = out.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(out, fused, atol=2e-5)
        np.testing.assert_allclose(out, ref, atol=2e-5)
    else:
        scale = np.abs(ref).max()
        assert np.abs(out - fused).max() <= scale / 64
        assert np.abs(out - ref).max() <= 0.02 * max(1.0, scale)


def _vjps(x, params, s1, s2, delta, shift, masked, dtype):
    """(loss, dx, param grads) of sum(out^2) through JAX's interpreted train
    kernel, JAX's reference_block, and the port; all dx canonical."""
    kw = _kw(delta, shift, masked, x.shape[1])
    xj, pj = jnp.asarray(x, _jdt(dtype)), tuple(jnp.asarray(p) for p in params)
    sj = (jnp.asarray(s1), jnp.asarray(s2))

    def loss_f(x_, p_):
        return jnp.sum(jswinblock.fused_swin_block_train(x_, p_, *sj, **kw).astype(jnp.float32) ** 2)

    def loss_r(x_, p_):
        return jnp.sum(jswinblock.reference_block(x_, p_, scales=sj, **kw).astype(jnp.float32) ** 2)

    v_in = shift - delta
    out = []
    for fn in (loss_f, loss_r):
        val, (gx, gp) = jax.value_and_grad(fn, argnums=(0, 1))(xj, pj)
        out.append((float(val), np.roll(np.asarray(gx, np.float32), (v_in, v_in), (1, 2)),
                    [np.asarray(g, np.float32) for g in gp]))
    xt = torch.roll(torch.from_numpy(x).to(_tdt(dtype)), (v_in, v_in), (1, 2)).requires_grad_()
    pt = [torch.from_numpy(p).requires_grad_() for p in params]
    y = swinblock.fused_swin_block(xt, pt, heads=HEADS, scale=SCALE, ws=WS, shift=shift, eps=EPS,
                                   scales=(torch.from_numpy(s1), torch.from_numpy(s2)))
    loss = (y.float() ** 2).sum()
    loss.backward()
    assert xt.grad.dtype == xt.dtype and all(p.grad.dtype == torch.float32 for p in pt)
    out.append((loss.item(), xt.grad.float().numpy(), [p.grad.numpy() for p in pt]))
    return out


@pytest.mark.parametrize("delta,shift,masked", CASES)
def test_block_vjp_matches_jax_f32(delta, shift, masked):
    """The plain VJP with live per-sample DropPath scales against jax.vjp of
    the interpreted whole-block VJP kernel and of reference_block: the
    loss, dx and all 13 parameter gradients."""
    rng = np.random.default_rng(20 + delta + shift)
    x = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    params = _params(rng)
    s1, s2 = np.array([1.25, 0.0], np.float32), np.array([0.0, 1.25], np.float32)
    (vf, gxf, gpf), (vr, gxr, gpr), (v, gx, gp) = _vjps(x, params, s1, s2, delta, shift, masked, "f32")
    for want_v, want_x, want_p in ((vf, gxf, gpf), (vr, gxr, gpr)):
        np.testing.assert_allclose(v, want_v, rtol=1e-5)
        np.testing.assert_allclose(gx, want_x, rtol=2e-4, atol=2e-4)
        for name, a, e in zip(swinblock.PARAM_NAMES, gp, want_p):
            np.testing.assert_allclose(a, e, rtol=2e-4, atol=2e-4, err_msg=name)


def test_block_vjp_matches_jax_bf16():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, 16, 16, C)).astype(np.float32)
    params = _params(rng)
    s1, s2 = np.array([1.25, 0.0], np.float32), np.array([0.0, 1.25], np.float32)
    (_, gxf, gpf), (_, gxr, _), (_, gx, gp) = _vjps(x, params, s1, s2, 4, 4, True, "bf16")
    assert np.abs(gx - gxr).max() <= 0.05 * max(1.0, np.abs(gxr).max())
    assert np.abs(gx - gxf).max() <= np.abs(gxf).max() / 32
    for name, a, e in zip(swinblock.PARAM_NAMES, gp, gpf):
        assert np.abs(a - e).max() <= np.abs(e).max() / 128, name


def test_eval_forward_equals_unit_scales():
    """Keep-scales of one are the eval forward exactly (the multiply by 1 is
    exact in either dtype)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, C)).astype(np.float32)).bfloat16()
    params = [torch.from_numpy(p) for p in _params(rng)]
    kw = dict(heads=HEADS, scale=SCALE, ws=WS, shift=4, eps=EPS)
    ones = torch.ones(2)
    torch.testing.assert_close(swinblock.fused_swin_block(x, params, **kw),
                               swinblock.fused_swin_block(x, params, scales=(ones, ones), **kw), rtol=0, atol=0)


def test_group_labels_and_mask_match_jax():
    """The plain versions' mask equals JAX's, bit for bit, and is -100
    exactly where JAX's group labels (what the kernel computes in place of
    the mask) differ, also where the image is one window (shift regions
    only)."""
    for h, w in ((32, 32), (16, 24), (8, 8)):
        lab = np.asarray(jswinblock._window_group_labels(h, w, WS, WS // 2)).reshape(-1, N)
        mask = winattn.shift_attn_mask(h, w, WS, WS // 2)
        np.testing.assert_array_equal(mask, jax_shift_attn_mask(h, w, WS, WS // 2))
        np.testing.assert_array_equal(np.where(lab[:, None, :] != lab[:, :, None], -100.0, 0.0), mask)
    assert winattn.shift_attn_mask(32, 32, WS, 0) is None


def test_shift_offsets_mod_image_size_deep_group():
    """The counterpart of tests/test_swinblock.py's deep-group realign test:
    four blocks (shifts 0, 4, 0, 4) chained in the canonical layout against
    JAX's roll-space chain, realigned as SwinTransformerBlock._chain_realign
    does (the third block needs a +ws roll: offsets taken mod ws instead of
    mod the image size displace the rest of the group).  Large bias
    tables; the output f32 within 2e-4, and the bias maps' gradients, the
    leaves most sensitive to a displaced window, within 5e-3 relative
    RMS."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 32, 32, C)).astype(np.float32)
    blocks = []
    for _ in range(4):
        p = list(_params(rng))
        p[12] = (rng.standard_normal((HEADS, N, N)) * 0.5).astype(np.float32)
        blocks.append(p)
    shifts = (0, 4, 0, 4)

    def jax_chain(x_, *bias_maps):
        v = 0
        for shift, p, bm in zip(shifts, blocks, bias_maps):
            delta = (shift - v) % WS
            realign = delta - (shift - v)
            if realign:
                x_ = jnp.roll(x_, (realign, realign), (1, 2))
            kw = _kw(delta, shift, bool(shift), 32)
            x_ = jswinblock.fused_swin_block(x_, tuple(jnp.asarray(a) for a in p[:12]) + (bm,), **kw)
            v = shift
        return jnp.roll(x_, (v, v), (1, 2)) if v else x_

    maps_j = [jnp.asarray(p[12]) for p in blocks]
    out_j, vjp = jax.vjp(jax_chain, jnp.asarray(x), *maps_j)
    g_out = rng.standard_normal(x.shape).astype(np.float32)
    grads_j = vjp(jnp.asarray(g_out))[1:]

    maps_t = [torch.from_numpy(p[12]).requires_grad_() for p in blocks]
    y = torch.from_numpy(x)
    for shift, p, bm in zip(shifts, blocks, maps_t):
        y = swinblock.fused_swin_block(y, [torch.from_numpy(a) for a in p[:12]] + [bm], heads=HEADS, scale=SCALE,
                                       ws=WS, shift=shift, eps=EPS)
    y.backward(torch.from_numpy(g_out))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(out_j), atol=2e-4)
    for i, (got, want) in enumerate(zip(maps_t, grads_j)):
        got, want = got.grad.double().numpy(), np.asarray(want, np.float64)
        rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2))
        assert rel < 5e-3, (i, rel)


# ---- the bf16 tensor-core route (csrc/swinblock_tc.cuh): which shapes take
# it, and its launch plan; the kernels themselves run only on the card
# (tests/test_torch_cuda_kernels.py)

# (C, hidden, heads, ws, dtype) of the default SwinIR's blocks (C 96, 6 heads
# of 16, 8 x 8 windows, MLP 192) and of other shapes on the route: C 32 and
# 192, heads of 32, hidden not a multiple of 64
TC_SHAPES = [(96, 192, 6, 8), (32, 64, 2, 8), (32, 96, 1, 8), (192, 384, 12, 8), (192, 384, 6, 8), (80, 144, 5, 8),
             (16, 16, 1, 8)]
# ... and off it: f32, 7 x 7 windows, C 240 (past MAX_C), heads of 24 and 30,
# hidden no multiple of 16, C no multiple of 16, hidden past MAX_HIDDEN
OFF_ROUTE = [((96, 192, 6, 8), torch.float32), ((96, 192, 6, 7), torch.bfloat16), ((240, 480, 8, 8), torch.bfloat16),
             ((96, 192, 4, 8), torch.bfloat16), ((180, 360, 6, 8), torch.bfloat16), ((96, 200, 6, 8), torch.bfloat16),
             ((72, 144, 3, 8), torch.bfloat16), ((96, 400, 6, 8), torch.bfloat16), ((96, 192, 6, 4), torch.bfloat16)]


@pytest.mark.parametrize("shape", TC_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_route_takes_bf16_blocks_to_the_tensor_cores(shape):
    assert swinblock.route(*shape, torch.bfloat16) == "tc"
    assert swinblock.route(*shape, torch.float32) == "cuda_core"


@pytest.mark.parametrize("shape,dtype", OFF_ROUTE, ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_route_keeps_other_shapes_on_the_cuda_cores(shape, dtype):
    assert swinblock.route(*shape, dtype) == "cuda_core"


def test_bwd_launches_agree_with_the_route():
    """Every route has its backward launch count, the tensor-core route's two
    (the rows kernel and the weight gradients), the CUDA-core route's the
    thirteen of its planner's launches, and chip_smoke.py's launches of a
    SwinIR() step follow the route of each dtype."""
    import chip_smoke

    assert swinblock.BWD_LAUNCHES == {"tc": 2, "cuda_core": 13}
    assert len(swinblock.f32_plan(16 * 128 * 128, 96, 192, 6, 8)["launches"]) == swinblock.BWD_LAUNCHES["cuda_core"]
    for shape in TC_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            assert swinblock.route(*shape, dtype) in swinblock.BWD_LAUNCHES
    for dtype in (torch.float32, torch.bfloat16):
        route = swinblock.route(96, 192, 6, 8, dtype)
        n = dict(zip(chip_smoke.COUNTERS, chip_smoke._per_step(kind="SwinIR", dtype=dtype)))
        tc = route == "tc"
        assert (n["swinblock_fwd"], n["swinblock_bwd"]) == (16, 16 * swinblock.BWD_LAUNCHES[route])
        assert (n["swinblock_tc_fwd"], n["swinblock_tc_bwd"]) == (16 * tc, 16 * tc * swinblock.BWD_LAUNCHES["tc"])


def _windows(batch, h, w):
    return batch * (h // 8) * (w // 8)


def _windows_taken(nwin, wg, grid):
    """The windows each persistent block takes, as the kernels' loop does:
    block b the window groups b, b + grid, ..., group q the windows q wg ..
    q wg + wg - 1 below nwin."""
    groups = -(-nwin // wg)
    return [[q * wg + w for q in range(b, groups, grid) for w in range(wg) if q * wg + w < nwin] for b in range(grid)]


# window counts: SwinIR()'s blocks at batch 16 and 1 (4,096 and 256 of its
# 128^2 tiles), ragged counts for two windows a block (289, 333) and small
# images that fill no card
WINDOW_COUNTS = [_windows(16, 128, 128), _windows(1, 128, 128), 289, 333, 264, 265, 131, 8, 3, 1]


@pytest.mark.parametrize("nwin", WINDOW_COUNTS)
@pytest.mark.parametrize("shape", TC_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tc_plan_covers_every_window_once_and_fits(shape, nwin):
    """Forward and backward rows plans: the persistent blocks' window groups
    cover every window exactly once (the last group may hold fewer windows
    than the block's warpgroups), each block's shared memory fits the
    H100's 232,448 bytes, and the grid puts a block on every SM (132) when
    the windows allow it."""
    c, hidden, heads, ws = shape
    for backward in (False, True):
        wg, nring, grid, smem = swinblock.tc_plan(nwin, c, hidden, backward)
        assert wg in (1, 2) and nring in (2, 3)
        assert smem == swinblock.tc_smem(c, hidden, wg, nring, backward) <= swinblock.SMEM_LIMIT
        taken = [w for block in _windows_taken(nwin, wg, grid) for w in block]
        assert sorted(taken) == list(range(nwin))
        assert grid <= -(-nwin // wg) and grid >= min(swinblock.SMS, -(-nwin // wg))
        if -(-nwin // 2) >= swinblock.SMS and swinblock.tc_smem(c, hidden, 2, 2, backward) <= swinblock.SMEM_LIMIT:
            assert wg == 2, "two windows a block where that still fills the card"


def test_tc_plan_fills_the_card_at_swinir_batches():
    """At batch 16 both kernels run 132 persistent blocks of two windows;
    at batch 1 (256 windows) one window a block, so that all 132 SMs have
    one (128 blocks of two would leave 4 idle)."""
    for backward in (False, True):
        assert swinblock.tc_plan(_windows(16, 128, 128), 96, 192, backward)[:3] == (2, 3, 132)
        wg, _, grid, _ = swinblock.tc_plan(_windows(1, 128, 128), 96, 192, backward)
        assert (wg, grid) == (1, 132)


def test_tc_shared_memory_and_slabs():
    """The shared-memory sizing and the slab table mirror the kernel's
    layout: per window two (forward) or three (backward) 64-token tiles, the
    transposed q, k, v and the token statistics; the ring; the backward's
    column sums; 40 bytes a slab; 1 KB of slack."""
    assert swinblock.tc_smem(96, 192, 2, 3, False) == (
        1024 + 3 * 16384 + 2 * (2 * 16384 + 288 * 128 + 2048) + swinblock.tc_slabs(96, 192, False) * 40)
    assert swinblock.tc_smem(96, 192, 2, 3, True) == (
        1024 + 3 * 16384 + 2 * (3 * 16384 + 288 * 128 + 2048) + 4 * (9 * 96 + 192) + swinblock.tc_slabs(96, 192, True) * 40)
    # forward: qkv in 3 N chunks of 128 x 2 K slabs, proj 2, the MLP 3 x (2 + 1)
    assert swinblock.tc_slabs(96, 192, False) == 6 + 2 + 9
    # backward: qkv 5 x 2, proj 2 x 2, the MLP 3 x (2 + 2), dh2 2 x 3, datt 2 x 2, dh1 2 x 5
    assert swinblock.tc_slabs(96, 192, True) == 10 + 4 + 12 + 6 + 4 + 10
    for shape in TC_SHAPES:
        for backward in (False, True):
            assert swinblock.tc_slabs(shape[0], shape[1], backward) <= swinblock._MAX_SLABS
