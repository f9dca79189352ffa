"""The backward of the port's convchain layer (pssr2_tpu_torch/ops/
convchain.py: ``reference_layer_bwd`` and the autograd of
``fused_conv_layer``) against the JAX package: ``jax.vjp`` of the Pallas
kernel ``convchain.fused_conv_layer`` in interpret mode (its backward is
``_layer_bwd_kernel``), and of the XLA twin
``convnhwc.reference_layer_nhwc`` (row 7 of the kernel table).

On the CPU the port's autograd takes its plain backward, so these tests
hold the function the CUDA backward kernels must compute;
tests/test_torch_cuda_kernels.py holds the kernels against it on the card.

Tolerances, as fractions of max |ref| of each gradient:
- against the Pallas kernel, the rounding is the same (the stat cotangents
  fold in f32 and round to the dtype; dx and dW accumulate in f32 from
  operands in the dtype), so f32 differs by summation order (1e-5) and
  bf16 by one bf16 ulp of dx (1/128) where an f32 ulp of difference in
  the forward's y or in dh moves a rounding;
- against XLA's autodiff of the NHWC twin, f32 likewise; in bf16 XLA
  rounds the conv's cotangent and dW to bf16 before the ReLU mask and the
  d(a, b) sums, so bf16 gets 2 bf16 ulps (1/64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.ops.pallas import convchain, convnhwc
from pssr2_tpu_torch.ops import convchain as tconvchain

torch.set_num_threads(2)

N, H, W, COUT = 2, 6, 16, 8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL_PALLAS = {"f32": 1e-5, "bf16": 1 / 128}
TOL_XLA = {"f32": 1e-5, "bf16": 1 / 64}


@pytest.fixture
def interpret_mode():
    old = convchain.MODE
    convchain.MODE = "interpret"
    yield
    convchain.MODE = old


def _inputs(seed, cin):
    """NHWC x, HWIO kernel, bias, ab, and the cotangents gy (NHWC), gs1,
    gs2, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, H, W, cin)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, cin, COUT)).astype(np.float32)
    b = rng.normal(0, 0.1, (COUT,)).astype(np.float32)
    ab = np.stack([rng.uniform(0.5, 1.5, cin), rng.normal(0, 0.3, cin)]).astype(np.float32)
    gy = rng.normal(0, 1, (N, H, W, COUT)).astype(np.float32)
    gs = rng.normal(0, 0.05, (2, COUT)).astype(np.float32)
    return x, k, b, ab, gy, gs[0], gs[1]


def _port(x, k, b, ab, gy, gs1, gs2, tdt):
    """The port's gradients through autograd on CPU tensors: dx (NHWC),
    dW (HWIO), dbias, dab (or None)."""
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    abt = None if ab is None else torch.from_numpy(ab).requires_grad_()
    y, s1, s2 = tconvchain.fused_conv_layer(xt, wt, bt, abt)
    torch.autograd.backward(
        (y, s1, s2), (torch.from_numpy(gy).to(tdt), torch.from_numpy(gs1), torch.from_numpy(gs2))
    )
    dw = np.transpose(wt.grad.numpy(), (2, 3, 1, 0))  # OIHW -> HWIO
    dab = None if abt is None else abt.grad.numpy()
    assert xt.grad.dtype == tdt
    return xt.grad.float().numpy(), dw, bt.grad.numpy(), dab


def _assert_close(port, ref, tol):
    for name, p, r in zip(("dx", "dw", "dbias", "dab"), port, ref):
        if p is None:
            continue
        r = np.asarray(r, np.float32)
        assert p.shape == r.shape, name
        err = np.abs(p - r).max()
        assert err <= tol * np.abs(r).max(), f"{name}: max abs error {err} > {tol} * {np.abs(r).max()}"


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False])
@pytest.mark.parametrize("cin", [1, 8, 16])
def test_backward_matches_pallas_vjp(interpret_mode, cin, relu_in, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    x, k, b, ab, gy, gs1, gs2 = _inputs(cin * 10 + relu_in, cin)
    port = _port(x, k, b, ab if relu_in else None, gy, gs1, gs2, tdt)

    def f(xt, wmat, bias, ab_):
        return convchain.fused_conv_layer(xt, wmat, bias, ab_ if relu_in else None, relu_in=relu_in)

    xt = jnp.asarray(np.transpose(x, (0, 1, 3, 2)), jdt)  # NHWC -> NHCW
    wmat = convchain.kernel_matrix(jnp.asarray(k))
    _, vjp = jax.vjp(f, xt, wmat, jnp.asarray(b), jnp.asarray(ab))
    gyt = jnp.asarray(np.transpose(gy, (0, 1, 3, 2)), jdt)
    dx, dwmat, dbias, dab = vjp((gyt, jnp.asarray(gs1), jnp.asarray(gs2)))
    dx = np.transpose(np.asarray(dx, np.float32), (0, 1, 3, 2))  # NHCW -> NHWC
    dw = np.transpose(np.asarray(dwmat).reshape(COUT, 3, 3, cin), (1, 2, 3, 0))  # -> HWIO
    _assert_close(port, (dx, dw, dbias, dab), TOL_PALLAS[dtype_name])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False])
def test_backward_matches_nhwc_reference_vjp(dtype_name, relu_in):
    jdt, tdt = DTYPES[dtype_name]
    x, k, b, ab, gy, gs1, gs2 = _inputs(7 + relu_in, 16)
    port = _port(x, k, b, ab if relu_in else None, gy, gs1, gs2, tdt)

    def f(xj, wk, bias, ab_):
        return convnhwc.reference_layer_nhwc(xj, wk, bias, ab_, relu_in=relu_in)

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), convnhwc.kernel_taps(jnp.asarray(k)), jnp.asarray(b), jnp.asarray(ab))
    dx, dwk, dbias, dab = vjp((jnp.asarray(gy, jdt), jnp.asarray(gs1), jnp.asarray(gs2)))
    dw = np.asarray(dwk, np.float32).reshape(3, 3, 16, COUT)
    _assert_close(port, (np.asarray(dx, np.float32), dw, dbias, dab), TOL_XLA[dtype_name])


def test_plain_backward_is_the_autograd_backward():
    """``reference_layer_bwd`` is what autograd of ``fused_conv_layer``
    returns on a CPU tensor, bit for bit, and it launches nothing."""
    x, k, b, ab, gy, gs1, gs2 = _inputs(5, 8)
    port = _port(x, k, b, ab, gy, gs1, gs2, torch.float32)
    y, _, _ = tconvchain.reference_layer(
        torch.from_numpy(x), torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()), torch.from_numpy(b),
        torch.from_numpy(ab),
    )
    dx, dw, dbias, dab = tconvchain.reference_layer_bwd(
        torch.from_numpy(x), torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()), y,
        torch.from_numpy(gy), torch.from_numpy(gs1), torch.from_numpy(gs2), torch.from_numpy(ab),
    )
    np.testing.assert_array_equal(port[0], dx.numpy())
    np.testing.assert_array_equal(port[1], np.transpose(dw.numpy(), (2, 3, 1, 0)))
    np.testing.assert_array_equal(port[2], dbias.numpy())
    np.testing.assert_array_equal(port[3], dab.numpy())
    assert tconvchain.launches == tconvchain.bwd_launches == 0


def test_only_cpu_tensors_take_the_plain_versions():
    """A tensor on any device but the CPU goes to the kernels' checks and
    launch, never to the plain versions: on a device that is not CUDA the
    wrappers raise."""
    from pssr2_tpu_torch.ops import ssimfused

    x = torch.zeros((1, 4, 4, 2), device="meta")
    w = torch.zeros((3, 2, 3, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tconvchain.fused_conv_layer(x, w, torch.zeros(3, device="meta"))
    img = torch.zeros((1, 1, 16, 16), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ssimfused.fused_ssim_parts(img, img, 1e-4, 9e-4, 11, 1.5)
    assert tconvchain.launches == tconvchain.bwd_launches == 0
    assert ssimfused.fwd_launches == ssimfused.bwd_launches == 0
