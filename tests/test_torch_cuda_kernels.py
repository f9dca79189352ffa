"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips, from a fixture, where there is no CUDA
device.  On a machine with an H100 and nvcc::

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: tests/conftest.py imports JAX, which the port's own
dependencies do not include.)

This file imports no JAX: the plain versions are the reference here, and
the CPU tests hold those against the JAX package.
"""

import pytest
import torch

from pssr2_tpu_torch.ops import chanstats, convchain, gradhist, q8chain, rdtail, ssimfused, swinblock, winattn

pytestmark = pytest.mark.cuda

# bf16 SSIM (band path) against the f32 kernel on the same maps: the five
# moments round to 8 bits before E[x^2] - E[x]^2 (a bf16 ulp at 1 is
# 0.0039); on the CPU the mean moved by 7e-4 at these maps.
BF16_SSIM_TOL = 0.02

# (Cin, Cout, H, W): the ResUNet's entry layer, ragged tiles and channel
# counts the kernel masks, and a deep-stage shape
SHAPES = [(1, 64, 16, 16), (3, 8, 10, 13), (16, 70, 9, 17), (96, 64, 24, 24), (512, 1024, 8, 8)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(device, dtype, cin, cout, h, w, relu_in, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(2, h, w, cin, generator=g).to(device, dtype)
    weight = (torch.randn(cout, cin, 3, 3, generator=g) / (3 * cin**0.5)).to(device)
    bias = (0.1 * torch.randn(cout, generator=g)).to(device)
    ab = None
    if relu_in:
        ab = torch.stack([torch.rand(cin, generator=g) + 0.5, 0.3 * torch.randn(cin, generator=g)]).to(device)
    return x, weight, bias, ab


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False], ids=["prologue", "entry"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_convchain_matches_plain(device, shape, relu_in, dtype):
    args = _inputs(device, dtype, *shape, relu_in)
    with torch.no_grad():
        before = convchain.launches
        got = convchain.fused_conv_layer(*args)
        assert convchain.launches == before + 1
        ref = convchain.reference_layer(*args)
    torch.cuda.synchronize()
    assert got[0].shape == ref[0].shape and got[0].dtype == dtype
    for name, (err, _, bound) in convchain.errors(got, ref).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def test_convchain_refuses_what_it_does_not_take(device):
    x, weight, bias, ab = _inputs(device, torch.float32, 8, 16, 8, 8, True)
    with torch.no_grad():
        with pytest.raises(ValueError):
            convchain.fused_conv_layer(x.permute(0, 2, 1, 3), weight, bias, ab)  # not contiguous
        with pytest.raises(TypeError):
            convchain.fused_conv_layer(x.half(), weight, bias, ab)
        with pytest.raises(ValueError):
            convchain.fused_conv_layer(x, weight[:, :4], bias, ab)
        with pytest.raises(ValueError):
            convchain.fused_conv_layer(x, weight, bias, ab[:, :4])


def _cotangents(device, dtype, y, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    cout = y.shape[-1]
    gy = torch.randn(y.shape, generator=g).to(device, dtype)
    gs1 = (0.01 * torch.randn(cout, generator=g)).to(device)
    gs2 = (0.01 * torch.randn(cout, generator=g)).to(device)
    return gy, gs1, gs2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False], ids=["prologue", "entry"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_convchain_bwd_matches_plain(device, shape, relu_in, dtype):
    """The backward kernels' dx, dW, dbias and d(a, b) against
    reference_layer_bwd, within convchain.BWD_TOLERANCE."""
    x, weight, bias, ab = _inputs(device, dtype, *shape, relu_in)
    with torch.no_grad():
        y, _, _ = convchain.fused_conv_layer(x, weight, bias, ab)
        gy, gs1, gs2 = _cotangents(device, dtype, y)
        before = convchain.bwd_launches
        got = convchain._launch_bwd(x, weight, y, gy, gs1, gs2, ab)
        assert convchain.bwd_launches == before + 2
        ref = convchain.reference_layer_bwd(x, weight, y, gy, gs1, gs2, ab)
    torch.cuda.synchronize()
    assert got[0].shape == x.shape and got[0].dtype == dtype and got[1].shape == weight.shape
    assert (got[3] is None) == (not relu_in)
    for name, (err, _, bound) in convchain.bwd_errors(got, ref).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def test_convchain_autograd_goes_through_kernels(device):
    """Under autograd a CUDA tensor launches the forward and both backward
    kernels, and the gradients match the plain backward."""
    x, weight, bias, ab = _inputs(device, torch.float32, 16, 32, 12, 12, True)
    x, weight, bias, ab = (t.clone().requires_grad_() for t in (x, weight, bias, ab))
    f0, b0 = convchain.launches, convchain.bwd_launches
    y, s1, s2 = convchain.fused_conv_layer(x, weight, bias, ab)
    (y.square().sum() + s1.sum() + 0.5 * s2.sum()).backward()
    assert (convchain.launches, convchain.bwd_launches) == (f0 + 1, b0 + 2)
    with torch.no_grad():
        ref = convchain.reference_layer_bwd(
            x, weight, y, 2 * y, torch.ones_like(s1), torch.full_like(s2, 0.5), ab
        )
    got = (x.grad, weight.grad, bias.grad, ab.grad)
    for name, (err, _, bound) in convchain.bwd_errors(got, ref).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


# (N, Cin, Cout, H, W) at the edges of the bf16 kernels' tiling: Cin not a
# multiple of the 64-channel K chunk (as 728 and 1000 are), Cout leaving a
# partial N tile, W and H off the 8x8 sub-tile, an odd Cout (single-element
# stores), the 8x8 image at batch 16 (the small-grid tiling), and a real
# RDResUNet width at batch 16
EDGE_SHAPES = [(2, 40, 192, 9, 20), (2, 200, 72, 8, 12), (2, 24, 33, 11, 8), (16, 64, 128, 8, 8),
               (16, 448, 256, 32, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False], ids=["prologue", "entry"])
@pytest.mark.parametrize("shape", EDGE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_convchain_tiling_edges_match_plain(device, shape, relu_in, dtype):
    """Forward and backward against the plain versions at the tiling's
    edges, within the unchanged TOLERANCE and BWD_TOLERANCE."""
    n, cin, cout, h, w = shape
    g = torch.Generator(device="cpu").manual_seed(n + cin + cout)
    x = torch.randn(n, h, w, cin, generator=g).to(device, dtype)
    weight = (torch.randn(cout, cin, 3, 3, generator=g) / (3 * cin**0.5)).to(device)
    bias = (0.1 * torch.randn(cout, generator=g)).to(device)
    ab = None
    if relu_in:
        ab = torch.stack([torch.rand(cin, generator=g) + 0.5, 0.3 * torch.randn(cin, generator=g)]).to(device)
    with torch.no_grad():
        got = convchain.fused_conv_layer(x, weight, bias, ab)
        ref = convchain.reference_layer(x, weight, bias, ab)
        torch.cuda.synchronize()
        for name, (err, _, bound) in convchain.errors(got, ref).items():
            assert err <= bound, f"forward {name}: max abs error {err} > {bound}"
        y = got[0]
        gy, gs1, gs2 = _cotangents(device, dtype, y)
        got_b = convchain._launch_bwd(x, weight, y, gy, gs1, gs2, ab)
        ref_b = convchain.reference_layer_bwd(x, weight, y, gy, gs1, gs2, ab)
    torch.cuda.synchronize()
    for name, (err, _, bound) in convchain.bwd_errors(got_b, ref_b).items():
        assert err <= bound, f"backward {name}: max abs error {err} > {bound}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_convchain_launches_per_call(device, dtype):
    """Either route adds exactly 1 forward launch a call and 2 backward
    launches (dx with d(a, b), then dW with dbias) under autograd, and its
    gradients match the plain backward."""
    x, weight, bias, ab = _inputs(device, dtype, 64, 96, 16, 16, True)
    x, weight, bias, ab = (t.clone().requires_grad_() for t in (x, weight, bias, ab))
    f0, b0 = convchain.launches, convchain.bwd_launches
    y, s1, s2 = convchain.fused_conv_layer(x, weight, bias, ab)
    assert (convchain.launches, convchain.bwd_launches) == (f0 + 1, b0)
    (y.float().square().sum() + s1.sum() + 0.5 * s2.sum()).backward()
    torch.cuda.synchronize()
    assert (convchain.launches, convchain.bwd_launches) == (f0 + 1, b0 + 2)
    with torch.no_grad():
        ref = convchain.reference_layer_bwd(
            x, weight, y, 2 * y, torch.ones_like(s1), torch.full_like(s2, 0.5), ab
        )
    got = (x.grad, weight.grad, bias.grad, ab.grad)
    for name, (err, _, bound) in convchain.bwd_errors(got, ref).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def _ssim_inputs(device, shape, seed=0, scale=1.0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    y = torch.rand(shape, generator=g)
    x = (y + 0.1 * torch.randn(shape, generator=g)).clamp(-0.2, 1.2)
    return (scale * x).to(device), (scale * y).to(device)


def _close(got, ref, key):
    """max |got - ref| within ssimfused.TOLERANCE[key]: absolute for the
    means, relative to max |ref| for the maps and gradients."""
    err = (got - ref).abs().max().item()
    bound = ssimfused.TOLERANCE[key] * (1.0 if key in ("s", "cs", "l1") else ref.abs().max().item())
    assert err <= bound, f"{key}: max abs error {err} > {bound}"


def _counts():
    return tuple(getattr(ssimfused, f"{k}_launches") for k in ("fwd", "bwd", "pool_fwd", "pool_bwd", "l0_fwd", "l0_bwd"))


def _delta(before):
    return tuple(a - b for a, b in zip(_counts(), before))


@pytest.mark.parametrize("win", [7, 11, 15])
@pytest.mark.parametrize("shape", [(2, 1, 64, 64), (3, 2, 45, 77), (1, 1, 0, 0), (2, 1, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)) if s[2] else "window")
def test_ssim_fwd_bwd_match_plain(device, shape, win):
    """The fused SSIM forward and backward (row 5) against reference_parts
    (the band-matrix form with autograd), within ssimfused.TOLERANCE, at
    the loss's window and two others; "window" is an image of exactly the
    window's size."""
    if not shape[2]:
        shape = (1, 1, win, win)
    x, y = _ssim_inputs(device, shape)
    c1, c2 = 0.01**2, 0.03**2
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    before = _counts()
    s, cs = ssimfused.fused_ssim_parts(xk, yk, c1, c2, win, 1.5)
    (s.sum() + 0.5 * cs.sum()).backward()
    assert _delta(before) == (1, 2, 0, 0, 0, 0)
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    s_ref, cs_ref = ssimfused.reference_parts(xr, yr, c1, c2, win, 1.5)
    (s_ref.sum() + 0.5 * cs_ref.sum()).backward()
    torch.cuda.synchronize()
    assert s.shape == cs.shape == shape[:2]
    _close(s, s_ref, "s")
    _close(cs, cs_ref, "cs")
    _close(xk.grad, xr.grad, "g")
    _close(yk.grad, yr.grad, "g")


@pytest.mark.parametrize("win", [7, 11])
@pytest.mark.parametrize("shape", [(2, 1, 64, 64), (3, 2, 46, 78), (16, 1, 256, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssim_pool_matches_plain(device, shape, win):
    """Row 4, a middle MS-SSIM level: (ssim, cs) means and the pooled maps
    against reference_parts_pool, and the gradients with cotangents on all
    four outputs."""
    x, y = _ssim_inputs(device, shape)
    c1, c2 = 0.01**2, 0.03**2
    g = torch.Generator(device="cpu").manual_seed(2)
    wp = torch.randn((2, *shape[:2], shape[2] // 2, shape[3] // 2), generator=g).to(device)
    outs = []
    before = _counts()
    for fn in (ssimfused.fused_ssim_parts_pool, ssimfused.reference_parts_pool):
        xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
        s, cs, xp, yp = fn(xk, yk, c1, c2, win, 1.5)
        (s.sum() + 0.5 * cs.sum() + (xp * wp[0]).sum() + (yp * wp[1]).sum()).backward()
        outs.append((s, cs, xp, yp, xk.grad, yk.grad))
    assert _delta(before) == (0, 0, 1, 2, 0, 0)
    torch.cuda.synchronize()
    got, ref = outs
    assert got[2].shape == (*shape[:2], shape[2] // 2, shape[3] // 2)
    for key, a, b in zip(("s", "cs", "pool", "pool", "g", "g"), got, ref):
        _close(a, b, key)


@pytest.mark.parametrize("divisor", [1.0, 255.0])
@pytest.mark.parametrize("shape", [(2, 1, 64, 64), (3, 1, 46, 78), (16, 1, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssim_level0_matches_plain(device, shape, divisor):
    """Row 3, MS-SSIM level 0 of the mixed loss: the divide, (ssim, cs),
    the windowed-L1 mean and the pooled maps against reference_level0, and
    the gradients with cotangents on all five outputs."""
    x, y = _ssim_inputs(device, shape, scale=divisor)
    c1, c2 = 0.01**2, 0.03**2
    g = torch.Generator(device="cpu").manual_seed(3)
    wp = torch.randn((2, *shape[:2], shape[2] // 2, shape[3] // 2), generator=g).to(device)
    wl = torch.randn(shape[:2], generator=g).to(device)
    outs = []
    before = _counts()
    for fn in (ssimfused.fused_level0_parts, ssimfused.reference_level0):
        xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
        s, cs, l1, xp, yp = fn(xk, yk, c1, c2, 11, 1.5, divisor)
        (s.sum() + 0.5 * cs.sum() + (l1 * wl).sum() + (xp * wp[0]).sum() + (yp * wp[1]).sum()).backward()
        outs.append((s, cs, l1, xp, yp, xk.grad, yk.grad))
    assert _delta(before) == (0, 0, 0, 0, 1, 2)
    torch.cuda.synchronize()
    got, ref = outs
    for key, a, b in zip(("s", "cs", "l1", "pool", "pool", "g", "g"), got, ref):
        _close(a, b, key)


def test_ms_ssim_loss_goes_through_the_kernels(device):
    """SSIMLoss(mix=0.8, ms=True).scaled on the training's shape family
    launches level 0, three pool levels and the last level, forward and
    backward, and matches the same loss on the CPU (plain versions)."""
    from pssr2_tpu_torch.util import SSIMLoss

    x, y = _ssim_inputs(device, (4, 1, 256, 256), scale=255.0)
    xk = x.clone().requires_grad_()
    before = _counts()
    loss = SSIMLoss(mix=0.8, ms=True).scaled(xk, y, 255)
    loss.backward()
    assert _delta(before) == (1, 2, 3, 6, 1, 2)
    xc = x.cpu().requires_grad_()
    ref = SSIMLoss(mix=0.8, ms=True).scaled(xc, y.cpu(), 255)
    ref.backward()
    assert abs(loss.item() - ref.item()) <= 1e-5
    err = (xk.grad.cpu() - xc.grad).abs().max().item()
    assert err <= ssimfused.TOLERANCE["g"] * xc.grad.abs().max().item(), err


def test_ssim_gate_sends_bf16_down_the_band_path(device):
    """bf16 maps take the band-matrix path on the card (no kernel launch),
    and agree with the f32 kernel within bf16's rounding of the moments."""
    from pssr2_tpu_torch.ops.ssim import ssim
    from pssr2_tpu_torch.util import SSIMLoss

    x, y = _ssim_inputs(device, (2, 1, 96, 96))
    before = _counts()
    s16 = ssim(x.bfloat16(), y.bfloat16(), data_range=1.0)
    loss16 = SSIMLoss(ms=False, dtype=torch.bfloat16)(x, y)
    assert _delta(before) == (0, 0, 0, 0, 0, 0)
    s32 = ssim(x, y, data_range=1.0)
    assert _delta(before) == (1, 0, 0, 0, 0, 0)
    assert s16.dtype == torch.bfloat16 and torch.isfinite(loss16)
    assert abs(s16.float().item() - s32.item()) <= BF16_SSIM_TOL


def test_ssim_loss_window_7_runs_the_kernel(device):
    from pssr2_tpu_torch.util import SSIMLoss

    x, y = _ssim_inputs(device, (2, 1, 64, 64))
    before = _counts()
    loss = SSIMLoss(ms=False, win_size=7)(x.requires_grad_(), y)
    loss.backward()
    assert _delta(before) == (1, 2, 0, 0, 0, 0)
    ref = SSIMLoss(ms=False, win_size=7)(x.detach().cpu(), y.cpu())
    assert abs(loss.item() - ref.item()) <= 1e-5


def test_ssim_refuses_what_it_does_not_take(device):
    """The kernels raise on what they do not take (the gate sends other
    dtypes to the band path before they get there): float64 maps, a window
    above MAX_WIN (ValueError naming it), mismatched shapes, odd dims for
    the pooling kernels."""
    x, y = _ssim_inputs(device, (1, 1, 40, 40))
    with pytest.raises(TypeError):
        ssimfused.fused_ssim_parts(x.double(), y.double(), 1e-4, 9e-4, 11, 1.5)
    with pytest.raises(ValueError, match=f"MAX_WIN={ssimfused.MAX_WIN}"):
        ssimfused.fused_ssim_parts(x, y, 1e-4, 9e-4, ssimfused.MAX_WIN + 2, 1.5)
    with pytest.raises(ValueError):
        ssimfused.fused_ssim_parts(x, y[..., :16], 1e-4, 9e-4, 11, 1.5)
    with pytest.raises(ValueError):
        ssimfused.fused_ssim_parts_pool(x[..., 1:], y[..., 1:], 1e-4, 9e-4, 11, 1.5)
    with pytest.raises(ValueError):
        ssimfused.fused_level0_parts(x[..., 1:, :], y[..., 1:, :], 1e-4, 9e-4, 11, 1.5, 255.0)


def test_ssim_largest_window_matches_plain(device):
    """The largest window the kernels take (dynamic shared memory above 48 KB)."""
    x, y = _ssim_inputs(device, (2, 1, 80, 96))
    win = ssimfused.MAX_WIN
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    s, cs = ssimfused.fused_ssim_parts(xk, yk, 1e-4, 9e-4, win, 4.0)
    (s.sum() - cs.sum()).backward()
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    s_ref, cs_ref = ssimfused.reference_parts(xr, yr, 1e-4, 9e-4, win, 4.0)
    (s_ref.sum() - cs_ref.sum()).backward()
    torch.cuda.synchronize()
    _close(s, s_ref, "s")
    _close(cs, cs_ref, "cs")
    _close(xk.grad, xr.grad, "g")
    _close(yk.grad, yr.grad, "g")


# (M, C, inter, G) of the RDNet block tail: tests/test_rdtail.py's shape,
# ragged sizes in every dimension, stage 0's first block, stage 6's last
# (the widest C and G), and the largest C and G the kernels take (past the
# tensor-core route's TC_MAX_C); then C 264 (no multiple of 16) with G 104
# (no multiple of 64), a ragged M whose I is split over 5 blocks, stage 2's
# first block (I split 3 ways) and stage 6's first at batch 16 (I split 8
# ways over a cluster).  In bf16 every shape of multiples of 8 up to
# TC_MAX_C takes the tensor cores, the others the CUDA cores.
RD_SHAPES = [(256, 48, 192, 24), (100, 37, 75, 13), (2048, 128, 512, 64), (1024, 816, 3264, 224),
             (64, rdtail.MAX_C, 160, rdtail.MAX_G), (512, 264, 1056, 104), (300, 160, 640, 104),
             (4096, 232, 928, 128), (1024, 368, 1472, 224)]


def _rd_inputs(device, dtype, m, c, inter, g, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s, sc=0.1: (sc * torch.randn(*s, generator=gen)).to(device)
    x = torch.randn(m, c, generator=gen).to(device, dtype)
    params = (mk(c, sc=0.5) + 1.0, mk(c), mk(c, inter, sc=c**-0.5), mk(inter), mk(inter, g, sc=inter**-0.5), mk(g))
    return x, params, torch.randn(m, g, generator=gen).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_rdtail_fwd_bwd_match_plain(device, shape, dtype):
    """The forward kernel against reference_tail within rdtail.TOLERANCE, and
    the backward launches against reference_tail_bwd within
    rdtail.BWD_TOLERANCE and the row-count bound of the sums; the route
    that ran is the one the shape and dtype pick, with its launch counts."""
    x, params, gout = _rd_inputs(device, dtype, *shape)
    m, c, inter, g = shape
    route = rdtail.route(c, inter, g, dtype)
    multiples = all(v % 8 == 0 for v in (c, inter, g))
    assert route == ("tc" if dtype == torch.bfloat16 and multiples and c <= rdtail.TC_MAX_C else "cuda_core")
    n_bwd = rdtail.BWD_LAUNCHES[route]
    with torch.no_grad():
        before = (rdtail.launches, rdtail.bwd_launches, rdtail.tc_launches, rdtail.tc_bwd_launches)
        out = rdtail._launch_fwd(x, params, 1e-6)
        grads = rdtail._launch_bwd(x, params, gout, 1e-6)
        tc = route == "tc"
        assert (rdtail.launches, rdtail.bwd_launches, rdtail.tc_launches, rdtail.tc_bwd_launches) == (
            before[0] + 1, before[1] + n_bwd, before[2] + int(tc), before[3] + (n_bwd if tc else 0))
        ref = rdtail.reference_tail(x, *params, eps=1e-6)
        ref_grads = rdtail.reference_tail_bwd(x, *params, gout, eps=1e-6)
    torch.cuda.synchronize()
    assert out.shape == (shape[0], shape[3]) and out.dtype == dtype
    err, _, bound = rdtail.errors(out, ref)
    assert err <= bound, f"out: max abs error {err} > {bound}"
    for name, (err, _, bound) in rdtail.bwd_errors(grads, ref_grads).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def test_rdtail_autograd_goes_through_kernels(device):
    """Under autograd a bf16 CUDA tensor launches the tensor-core forward and
    its four backward kernels, and the parameters' gradients come back in
    f32."""
    x, params, gout = _rd_inputs(device, torch.bfloat16, 300, 40, 160, 24)
    assert rdtail.route(40, 160, 24, torch.bfloat16) == "tc"
    x = x.clone().requires_grad_()
    params = [p.clone().requires_grad_() for p in params]
    f0, b0, t0 = rdtail.launches, rdtail.bwd_launches, rdtail.tc_bwd_launches
    out = rdtail.fused_rd_tail(x, *params, eps=1e-6)
    out.backward(gout)
    assert (rdtail.launches, rdtail.bwd_launches, rdtail.tc_bwd_launches) == (f0 + 1, b0 + 4, t0 + 4)
    with torch.no_grad():
        ref = rdtail.reference_tail_bwd(x, *params, gout, eps=1e-6)
    got = (x.grad, *(p.grad for p in params))
    assert x.grad.dtype == torch.bfloat16 and all(p.grad.dtype == torch.float32 for p in params)
    for name, (err, _, bound) in rdtail.bwd_errors(got, ref).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def test_rdtail_refuses_what_it_does_not_take(device):
    x, params, _ = _rd_inputs(device, torch.float32, 64, 32, 64, 16)
    with pytest.raises(TypeError):
        rdtail.fused_rd_tail(x.half(), *params, eps=1e-6)
    with pytest.raises(ValueError):
        rdtail.fused_rd_tail(x[:, :16], *params, eps=1e-6)
    with pytest.raises(ValueError, match="G <="):
        wide = (*params[:4], torch.zeros(64, rdtail.MAX_G + 1, device=device), torch.zeros(rdtail.MAX_G + 1, device=device))
        rdtail.fused_rd_tail(x, *wide, eps=1e-6)


# (B, H, W, C, heads, ws, hidden) of the Swin block: the default SwinIR's
# widths on a small image and at its canonical shape (batch 16, 128^2:
# 4,096 windows); 4 x 4 windows (16 tokens) with a head dimension of 15 and
# no width a multiple of 64; SwinIR-M's widths (C 180, 6 heads of 30, MLP
# 360); the largest C and hidden the kernels take, at a head dimension of 32
SWIN_SHAPES = [(2, 16, 16, 96, 6, 8, 192), (16, 128, 128, 96, 6, 8, 192), (1, 24, 16, 60, 4, 4, 120),
               (1, 16, 16, 180, 6, 8, 360), (1, 16, 16, swinblock.MAX_C, 6, 8, swinblock.MAX_HIDDEN)]


def _swin_inputs(device, dtype, b, h, w, c, heads, ws, hidden, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    mk = lambda *s, sc=0.1: (sc * torch.randn(*s, generator=gen)).to(device)
    n = ws * ws
    x = torch.randn(b, h, w, c, generator=gen).to(device, dtype)
    params = (mk(c, sc=0.5) + 1.0, mk(c), mk(c, 3 * c, sc=c**-0.5), mk(3 * c), mk(c, c, sc=c**-0.5), mk(c),
              mk(c, sc=0.5) + 1.0, mk(c), mk(c, hidden, sc=c**-0.5), mk(hidden), mk(hidden, c, sc=hidden**-0.5),
              mk(c), mk(heads, n, n, sc=0.5))
    scales = (torch.tensor([1.25, 0.0] * b, device=device)[:b], torch.tensor([0.0, 1.25] * b, device=device)[:b])
    return x, params, scales, torch.randn(b, h, w, c, generator=gen).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("scaled", [False, True], ids=["eval", "droppath"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("shape", SWIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_swinblock_fwd_bwd_match_plain(device, shape, shifted, scaled, dtype):
    """The forward kernel against reference_block within
    swinblock.TOLERANCE, and the two backward launches against
    reference_block_bwd within swinblock.BWD_TOLERANCE and the row-count
    bound of the sums; the bias map of the shapes is large (0.5), so the
    shift mask and the label regions show."""
    b, h, w, c, heads, ws, hidden = shape
    x, params, scales, gout = _swin_inputs(device, dtype, *shape)
    kw = dict(heads=heads, ws=ws, shift=ws // 2 if shifted else 0, eps=1e-6, scales=scales if scaled else None)
    route = swinblock.route(c, hidden, heads, ws, dtype)
    tc, n_bwd = route == "tc", swinblock.BWD_LAUNCHES[route]
    with torch.no_grad():
        before = _swin_counts()
        out = swinblock._launch_fwd(x, params, kw["heads"], ws, kw["shift"], 1e-6, kw["scales"])
        grads = swinblock._launch_bwd(x, params, gout, kw["heads"], ws, kw["shift"], 1e-6, kw["scales"])
        assert _swin_counts() == (before[0] + 1, before[1] + n_bwd, before[2] + int(tc), before[3] + n_bwd * tc)
        ref = swinblock.reference_block(x, params, **kw)
        ref_grads = swinblock.reference_block_bwd(x, params, gout, **kw)
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == dtype
    err, rel, bound = swinblock.errors(out, ref)
    print(f"out {err:.3g} (rel {rel:.2g}) <= {bound:.3g}")
    assert err <= bound, f"out: max abs error {err} > {bound}"
    errs = swinblock.bwd_errors(grads, ref_grads)
    print(" ".join(f"{k} {e:.3g} (rel {r:.2g})" for k, (e, r, _) in errs.items()))
    for name, (err, _, bound) in errs.items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def _swin_counts():
    return swinblock.launches, swinblock.bwd_launches, swinblock.tc_launches, swinblock.tc_bwd_launches


def test_swinblock_autograd_goes_through_kernels(device):
    """Under autograd a bf16 CUDA tensor on the tensor-core route launches
    the tensor-core forward and both backward kernels (counted); the scale
    fold and the parameters' f32 gradients come back as the plain versions
    give them."""
    x, params, scales, gout = _swin_inputs(device, torch.bfloat16, 2, 16, 16, 48, 3, 8, 96)
    assert swinblock.route(48, 96, 3, 8, torch.bfloat16) == "tc"
    kw = dict(heads=3, scale=0.25, ws=8, shift=4, eps=1e-6, scales=scales)
    xk = x.clone().requires_grad_()
    pk = [p.clone().requires_grad_() for p in params]
    f0, b0, t0, tb0 = _swin_counts()
    swinblock.fused_swin_block(xk, pk, **kw).backward(gout)
    n_bwd = swinblock.BWD_LAUNCHES["tc"]
    assert _swin_counts() == (f0 + 1, b0 + n_bwd, t0 + 1, tb0 + n_bwd)
    folded = [p.clone().requires_grad_() for p in params]
    with torch.no_grad():
        ref = swinblock.reference_block_bwd(x, swinblock._fold_scale(folded, 0.25), gout,
                                            **{k: v for k, v in kw.items() if k != "scale"})
    ref_p = torch.autograd.grad(swinblock._fold_scale(folded, 0.25)[2:4], folded[2:4], ref[3:5])
    assert xk.grad.dtype == torch.bfloat16 and all(p.grad.dtype == torch.float32 for p in pk)
    got = (xk.grad, *(p.grad for p in pk))
    want = (ref[0], ref[1], ref[2], *ref_p, *ref[5:])
    for name, (err, _, bound) in swinblock.bwd_errors(got, want).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def test_swinblock_refuses_what_it_does_not_take(device):
    x, params, _, _ = _swin_inputs(device, torch.float32, 1, 16, 16, 48, 3, 8, 96)
    with pytest.raises(TypeError):
        swinblock._launch_fwd(x.half(), params, 3, 8, 0, 1e-6)
    with pytest.raises(ValueError):
        swinblock._launch_fwd(x[..., :40], params, 3, 8, 0, 1e-6)
    with pytest.raises(ValueError, match="C <="):
        xw, pw, _, _ = _swin_inputs(device, torch.float32, 1, 8, 8, swinblock.MAX_C + 6, 6, 8, 96)
        swinblock._launch_fwd(xw, pw, 6, 8, 0, 1e-6)
    with pytest.raises(ValueError, match="hidden <="):
        xw, pw, _, _ = _swin_inputs(device, torch.float32, 1, 8, 8, 48, 3, 8, swinblock.MAX_HIDDEN + 8)
        swinblock._launch_fwd(xw, pw, 3, 8, 0, 1e-6)
    with pytest.raises(ValueError, match="ws"):
        xw, pw, _, _ = _swin_inputs(device, torch.float32, 1, 9, 9, 48, 3, 9, 96)
        swinblock._launch_fwd(xw, pw, 3, 9, 0, 1e-6)
    with pytest.raises(ValueError, match="head dimension"):
        xw, pw, _, _ = _swin_inputs(device, torch.float32, 1, 8, 8, 132, 2, 8, 96)
        swinblock._launch_fwd(xw, pw, 2, 8, 0, 1e-6)


# (B, H, W, C, heads, hidden) of the bf16 tensor-core route (8 x 8
# windows): C 32, 96 and 192, heads of 16 and 32 channels, hidden not a
# multiple of 64; 289 and 320 windows take two windows a block (289 leaves
# the last block's second warpgroup without a window, 320 gives some
# blocks two window groups), the small ones one.
TC_SHAPES = [(1, 136, 136, 32, 2, 64), (1, 136, 136, 32, 1, 96), (2, 16, 16, 96, 6, 192), (5, 64, 64, 96, 3, 192),
             (1, 16, 24, 192, 12, 384), (1, 136, 136, 192, 6, 384), (3, 16, 8, 80, 5, 144)]


@pytest.mark.parametrize("scaled", [False, True], ids=["eval", "droppath"])
@pytest.mark.parametrize("shifted", [False, True], ids=["plain", "shifted"])
@pytest.mark.parametrize("shape", TC_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_swinblock_tc_matches_plain(device, shape, shifted, scaled):
    """The tensor-core forward and both backward launches against
    reference_block and reference_block_bwd within the unchanged
    swinblock.TOLERANCE and BWD_TOLERANCE (and the row-count bound of the
    sums), with the tensor-core launches counted."""
    b, h, w, c, heads, hidden = shape
    assert swinblock.route(c, hidden, heads, 8, torch.bfloat16) == "tc"
    x, params, scales, gout = _swin_inputs(device, torch.bfloat16, b, h, w, c, heads, 8, hidden)
    kw = dict(heads=heads, ws=8, shift=4 if shifted else 0, eps=1e-6, scales=scales if scaled else None)
    n_bwd = swinblock.BWD_LAUNCHES["tc"]
    with torch.no_grad():
        before = _swin_counts()
        out = swinblock._launch_fwd(x, params, heads, 8, kw["shift"], 1e-6, kw["scales"])
        grads = swinblock._launch_bwd(x, params, gout, heads, 8, kw["shift"], 1e-6, kw["scales"])
        assert _swin_counts() == (before[0] + 1, before[1] + n_bwd, before[2] + 1, before[3] + n_bwd)
        ref = swinblock.reference_block(x, params, **kw)
        ref_grads = swinblock.reference_block_bwd(x, params, gout, **kw)
    torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == torch.bfloat16
    err, rel, bound = swinblock.errors(out, ref)
    print(f"plan {swinblock.tc_plan(b * h * w // 64, c, hidden, True)}: out {err:.3g} (rel {rel:.2g}) <= {bound:.3g}")
    assert err <= bound, f"out: max abs error {err} > {bound}"
    errs = swinblock.bwd_errors(grads, ref_grads)
    print(" ".join(f"{k} {e:.3g} (rel {r:.2g})" for k, (e, r, _) in errs.items()))
    for name, (err, _, bound) in errs.items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def test_swinblock_tc_failure_raises(device, monkeypatch):
    """A refused tensor-core launch raises: a bf16 CUDA tensor on the route
    never falls back to the CUDA-core kernels or the plain version."""
    x, params, _, gout = _swin_inputs(device, torch.bfloat16, 2, 16, 16, 96, 6, 8, 192)
    monkeypatch.setattr(swinblock, "tc_plan", lambda *a: (3, 3, 1, 0))  # three warpgroups: refused
    before = _swin_counts()
    with torch.no_grad():
        with pytest.raises(RuntimeError, match="swin_tc_fwd"):
            swinblock._launch_fwd(x, params, 6, 8, 0, 1e-6)
        with pytest.raises(RuntimeError, match="swin_tc_bwd"):
            swinblock._launch_bwd(x, params, gout, 6, 8, 0, 1e-6)
    assert _swin_counts() == before


# (batch, H, W, C, heads, ws): the default SwinIR's attention, small and at
# its canonical windows (4,096 x 64 x 288), SwinIR-L's widths (C 240, 8
# heads of 30), and 4 x 4 windows
WIN_SHAPES = [(2, 32, 32, 96, 6, 8), (16, 128, 128, 96, 6, 8), (1, 16, 32, 240, 8, 8), (3, 8, 12, 60, 4, 4)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
@pytest.mark.parametrize("shape", WIN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_winattn_matches_plain(device, shape, masked, dtype):
    """The window-attention kernel in both layouts against its plain
    versions within winattn.TOLERANCE."""
    b, h, w, c, heads, ws = shape
    gen = torch.Generator(device="cpu").manual_seed(1)
    qkv = torch.randn(b, h, w, 3 * c, generator=gen).to(device, dtype)
    bias = (0.5 * torch.randn(heads, ws * ws, ws * ws, generator=gen)).to(device)
    spec = (h, w, ws, ws // 2) if masked else None
    mask = winattn._mask_tensor(spec, device)
    scale = (c // heads) ** -0.5
    with torch.no_grad():
        before = winattn.launches
        img = winattn.fused_window_attention_2d(qkv, bias, spec, scale, heads, ws)
        wins = winattn.windows(qkv, ws)
        flat = winattn.fused_window_attention(wins, bias, spec, scale, heads)
        assert winattn.launches == before + 2
        ref = winattn.reference_window_attention_2d(qkv, bias, mask, scale, heads, ws)
        ref_flat = winattn.reference_window_attention(wins, bias, mask, scale, heads)
    torch.cuda.synchronize()
    for got, want in ((img, ref), (flat, ref_flat)):
        assert got.shape == want.shape and got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        bound = winattn.TOLERANCE[dtype] * want.float().abs().max().item()
        print(f"winattn {err:.3g} <= {bound:.3g}")
        assert err <= bound


def test_winattn_backward_and_refusals(device):
    """The gradient recomputes through the plain version (no kernel); heads
    wider than MAX_HEAD_DIM and windows past MAX_N raise."""
    gen = torch.Generator(device="cpu").manual_seed(2)
    qkv = torch.randn(2, 16, 16, 3 * 48, generator=gen).to(device).requires_grad_()
    bias = (0.1 * torch.randn(3, 64, 64, generator=gen)).to(device).requires_grad_()
    before = winattn.launches
    out = winattn.fused_window_attention_2d(qkv, bias, (16, 16, 8, 4), 0.25, 3, 8)
    out.square().sum().backward()
    assert winattn.launches == before + 1
    q2, b2 = qkv.detach().clone().requires_grad_(), bias.detach().clone().requires_grad_()
    winattn.reference_window_attention_2d(q2, b2, winattn._mask_tensor((16, 16, 8, 4), device), 0.25, 3, 8) \
        .square().sum().backward()
    for got, want in ((qkv.grad, q2.grad), (bias.grad, b2.grad)):
        assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()
    with torch.no_grad():
        with pytest.raises(ValueError, match="channels"):
            winattn.fused_window_attention_2d(torch.zeros(1, 8, 8, 3 * 66, device=device), bias[:2], None, 1.0, 2, 8)
        with pytest.raises(ValueError, match="tokens"):
            winattn.fused_window_attention_2d(torch.zeros(1, 9, 9, 3 * 48, device=device),
                                              torch.zeros(3, 81, 81, device=device), None, 1.0, 3, 9)


# ---- the learned crappifier's soft histogram, the BatchNorm sums, int8 serving ----


@pytest.mark.parametrize("n", [16384, 1000, 37], ids=lambda n: f"N{n}")
def test_gradhist_matches_plain(device, n):
    """Forward and backward at the crappifier's N and at ragged N (the masked tail)."""
    gen = torch.Generator(device="cpu").manual_seed(n)
    values = (30 * torch.randn(4, n, generator=gen)).to(device)
    g = torch.randn(4, 512, generator=gen).to(device)
    centers = gradhist.bin_centers().to(device)
    before = (gradhist.launches, gradhist.bwd_launches)
    v = values.clone().requires_grad_()
    hist = gradhist.GradHist(sigma=5)(v)
    (hist * g).sum().backward()
    assert (gradhist.launches, gradhist.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = gradhist.gradhist_plain(values, centers, 5.0)
    ref_dv = gradhist.gradhist_bwd_plain(values, centers, 5.0, g)
    torch.cuda.synchronize()
    err, ratio = gradhist.errors(hist.detach(), ref, n)
    err_b, ratio_b = gradhist.bwd_errors(v.grad, ref_dv, g, 5.0)
    print(f"gradhist N {n}: fwd {err:.3g} ({ratio:.3g} of its bound), bwd {err_b:.3g} ({ratio_b:.3g})")
    assert ratio <= 1 and ratio_b <= 1


def test_gradhist_refuses_what_it_does_not_take(device):
    centers = gradhist.bin_centers().to(device)
    with pytest.raises(TypeError):
        gradhist.gradhist(torch.zeros(2, 8, device=device, dtype=torch.float64), centers, 5.0)
    with pytest.raises(ValueError):
        gradhist.gradhist(torch.zeros(2, 8, 2, device=device)[..., 0], centers, 5.0)  # not contiguous


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,c", [(262144, 1), (65536, 64), (1024, 1024), (1000, 96), (77, 300)],
                         ids=lambda v: str(v))
def test_dual_sums_match_plain(device, rows, c, dtype):
    gen = torch.Generator(device="cpu").manual_seed(rows + c)
    x = (torch.randn(rows, c, generator=gen) + 0.3).to(device, dtype)
    y = torch.randn(rows, c, generator=gen).to(device, dtype)
    before = chanstats.launches
    got = chanstats.dual_sums(x, y)
    assert chanstats.launches == before + 1 and got.shape == (2, c) and got.dtype == torch.float32
    err, ratio = chanstats.errors(got, x, y)
    print(f"dual_sums {rows}x{c} {dtype}: {err:.3g} ({ratio:.3g} of its bound)")
    assert ratio <= 1
    with pytest.raises(TypeError):
        chanstats.dual_sums(x, y.float() if dtype == torch.bfloat16 else y.bfloat16())


def test_train_resblock_launches_dual_sums(device):
    """A train-mode ResBlock's backward takes the last affine's sums from the kernel."""
    from pssr2_tpu_torch.models.blocks import ResBlock

    blk = ResBlock(8, 64, 1, device=device).train()
    x = torch.randn(2, 16, 16, 8, device=device, requires_grad=True)
    before = chanstats.launches
    blk(x).square().sum().backward()
    assert chanstats.launches == before + 1 and torch.isfinite(x.grad).all()


@pytest.mark.parametrize("out", ["int8", "f32", "bf16"])
@pytest.mark.parametrize("cin,cout,k,h,w", [(1, 64, 3, 20, 24), (64, 64, 3, 16, 16), (33, 70, 3, 9, 17),
                                            (48, 32, 1, 12, 20), (768, 512, 3, 16, 16), (1024, 1024, 3, 8, 8)],
                         ids=lambda v: str(v))
def test_q8_layer_matches_plain(device, cin, cout, k, h, w, out):
    gen = torch.Generator(device="cpu").manual_seed(cin * cout + k)
    x8 = torch.randint(-127, 128, (2, h, w, cin), generator=gen, dtype=torch.int8).to(device)
    w8 = torch.randint(-127, 128, (cout, cin, k, k), generator=gen, dtype=torch.int8).to(device)
    affine = torch.stack([torch.rand(cout, generator=gen) * 1e-3, torch.randn(cout, generator=gen)]).to(device)
    last, dtype = out != "int8", {"int8": torch.bfloat16, "f32": torch.float32, "bf16": torch.bfloat16}[out]
    before = q8chain.launches
    got = q8chain.q8_conv_layer(x8, w8, affine, last=last, out_dtype=dtype)
    assert q8chain.launches == before + 1
    ref = q8chain.reference_q8_layer(x8, w8, affine, last=last, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got, ref), (got.float() - ref.float()).abs().max().item()


def test_quantized_resunet_serves_on_the_card(device):
    """A small int8 ResUNet on the card: every int8 conv launches the
    kernel, and the f32-glue output equals the CPU executor's."""
    from pssr2_tpu_torch.models import ResUNet
    from pssr2_tpu_torch.quant import quantize_resunet

    torch.manual_seed(0)
    model = ResUNet(hidden=[32, 64], depth=1, device="cpu")
    calib = [torch.rand(2, 1, 32, 32).numpy() * 255]
    q = quantize_resunet(model, calib)
    x = torch.rand(2, 1, 32, 32) * 255
    with torch.inference_mode():
        ref = q(x)
        before = q8chain.launches
        got = q.to(device)(x.to(device)).cpu()
    assert q8chain.launches - before == 3 * 3 + 1  # 3 blocks of 2 convs and a 1x1, and the recon's pre-conv
    assert (got - ref).abs().max().item() <= 1e-3
