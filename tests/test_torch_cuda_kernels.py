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

from pssr2_tpu_torch.ops import convchain, ssimfused

pytestmark = pytest.mark.cuda

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


def _ssim_inputs(device, shape, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    y = torch.rand(shape, generator=g)
    x = (y + 0.1 * torch.randn(shape, generator=g)).clamp(-0.2, 1.2)
    return x.to(device), y.to(device)


@pytest.mark.parametrize("shape", [(2, 1, 64, 64), (3, 2, 45, 77), (1, 1, 11, 11), (2, 1, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_ssim_fwd_bwd_match_plain(device, shape):
    """The fused SSIM forward and backward against reference_parts (the
    band-matrix form with autograd), within ssimfused.TOLERANCE."""
    x, y = _ssim_inputs(device, shape)
    c1, c2 = 0.01**2, 0.03**2
    xk, yk = x.clone().requires_grad_(), y.clone().requires_grad_()
    f0, b0 = ssimfused.fwd_launches, ssimfused.bwd_launches
    s, cs = ssimfused.fused_ssim_parts(xk, yk, c1, c2, 11, 1.5)
    (s.sum() + 0.5 * cs.sum()).backward()
    assert (ssimfused.fwd_launches, ssimfused.bwd_launches) == (f0 + 1, b0 + 2)
    xr, yr = x.clone().requires_grad_(), y.clone().requires_grad_()
    s_ref, cs_ref = ssimfused.reference_parts(xr, yr, c1, c2, 11, 1.5)
    (s_ref.sum() + 0.5 * cs_ref.sum()).backward()
    torch.cuda.synchronize()
    assert s.shape == cs.shape == shape[:2]
    assert (s - s_ref).abs().max().item() <= ssimfused.TOLERANCE["s"]
    assert (cs - cs_ref).abs().max().item() <= ssimfused.TOLERANCE["cs"]
    for got, ref in ((xk.grad, xr.grad), (yk.grad, yr.grad)):
        err = (got - ref).abs().max().item()
        assert err <= ssimfused.TOLERANCE["g"] * ref.abs().max().item(), err


def test_ssim_refuses_what_it_does_not_take(device):
    x, y = _ssim_inputs(device, (1, 1, 32, 32))
    with pytest.raises(TypeError):
        ssimfused.fused_ssim_parts(x.double(), y.double(), 1e-4, 9e-4, 11, 1.5)
    with pytest.raises(ValueError):
        ssimfused.fused_ssim_parts(x, y, 1e-4, 9e-4, 7, 1.5)
    with pytest.raises(ValueError):
        ssimfused.fused_ssim_parts(x, y[..., :16], 1e-4, 9e-4, 11, 1.5)
