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

from pssr2_tpu_torch.ops import convchain

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
    with pytest.raises(RuntimeError, match="forward only"):
        convchain.fused_conv_layer(x, weight.requires_grad_(), bias, ab)
