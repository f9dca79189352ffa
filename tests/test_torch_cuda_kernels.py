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

from pssr2_tpu_torch.ops import convchain, rdtail, ssimfused

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
# (the widest C and G), and the largest C and G the kernels take
RD_SHAPES = [(256, 48, 192, 24), (100, 37, 75, 13), (2048, 128, 512, 64), (1024, 816, 3264, 224),
             (64, rdtail.MAX_C, 160, rdtail.MAX_G)]


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
    the two backward launches against reference_tail_bwd within
    rdtail.BWD_TOLERANCE and the row-count bound of the sums."""
    x, params, gout = _rd_inputs(device, dtype, *shape)
    with torch.no_grad():
        before = (rdtail.launches, rdtail.bwd_launches)
        out = rdtail._launch_fwd(x, params, 1e-6)
        grads = rdtail._launch_bwd(x, params, gout, 1e-6)
        assert (rdtail.launches, rdtail.bwd_launches) == (before[0] + 1, before[1] + 2)
        ref = rdtail.reference_tail(x, *params, eps=1e-6)
        ref_grads = rdtail.reference_tail_bwd(x, *params, gout, eps=1e-6)
    torch.cuda.synchronize()
    assert out.shape == (shape[0], shape[3]) and out.dtype == dtype
    err, _, bound = rdtail.errors(out, ref)
    assert err <= bound, f"out: max abs error {err} > {bound}"
    for name, (err, _, bound) in rdtail.bwd_errors(grads, ref_grads).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


def test_rdtail_autograd_goes_through_kernels(device):
    """Under autograd a CUDA tensor launches the forward and both backward
    kernels, and the parameters' gradients come back in f32."""
    x, params, gout = _rd_inputs(device, torch.bfloat16, 300, 40, 160, 24)
    x = x.clone().requires_grad_()
    params = [p.clone().requires_grad_() for p in params]
    f0, b0 = rdtail.launches, rdtail.bwd_launches
    out = rdtail.fused_rd_tail(x, *params, eps=1e-6)
    out.backward(gout)
    assert (rdtail.launches, rdtail.bwd_launches) == (f0 + 1, b0 + 2)
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
