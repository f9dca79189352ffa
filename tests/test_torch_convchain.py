"""The port's convchain layer (pssr2_tpu_torch/ops/convchain.py) against
the JAX package: the Pallas kernel ``convchain.fused_conv_layer`` in
interpret mode, its ``reference_layer``, and the NHWC twins
``convnhwc.reference_layer_nhwc`` and ``fusedlayer.fused_layer_reference``.

On the CPU the port's wrapper takes its plain version, so these tests hold
the function the CUDA kernel must compute; tests/test_torch_cuda_kernels.py
holds the kernel against that plain version on the card.

Tolerances are those the kernel is held to against its plain version
(``pssr2_tpu_torch/ops/convchain.py:TOLERANCE``): in f32 only the order of
summation differs; in bf16 an output may differ by one bf16 ulp, since one
f32 ulp of difference can move its rounding and XLA's CPU backend computes
bf16 elementwise ops in f32 and may drop an intermediate rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.ops.pallas import convchain, convnhwc, fusedlayer
from pssr2_tpu_torch.ops import convchain as tconvchain

torch.set_num_threads(2)

N, H, W, COUT = 2, 6, 16, 8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret_mode():
    old = convchain.MODE
    convchain.MODE = "interpret"
    yield
    convchain.MODE = old


def _inputs(seed, cin, bias=True):
    """NHWC x, HWIO kernel, bias, ab as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, H, W, cin)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, cin, COUT)).astype(np.float32)
    b = rng.normal(0, 0.1, (COUT,)).astype(np.float32) if bias else np.zeros(COUT, np.float32)
    ab = np.stack([rng.uniform(0.5, 1.5, cin), rng.normal(0, 0.3, cin)]).astype(np.float32)
    return x, k, b, ab


def _port(x, k, b, ab, tdt):
    """The port's wrapper on CPU tensors: (y NHWC, s1, s2)."""
    y, s1, s2 = tconvchain.fused_conv_layer(
        torch.from_numpy(x).to(tdt),
        torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()),
        torch.from_numpy(b),
        None if ab is None else torch.from_numpy(ab),
    )
    assert y.dtype == tdt and s1.dtype == s2.dtype == torch.float32
    return y, s1, s2


def _assert_close(port, ref):
    """``ref`` = JAX (y NHWC, s1, s2) arrays; held to convchain.TOLERANCE."""
    y = torch.tensor(np.asarray(ref[0], np.float32)).to(port[0].dtype)
    ref = (y, *(torch.tensor(np.asarray(s, np.float32)) for s in ref[1:]))
    assert port[0].shape == ref[0].shape
    for name, (err, _, bound) in tconvchain.errors(port, ref).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False])
@pytest.mark.parametrize("cin", [1, 8, 16])
def test_layer_matches_pallas_and_reference(interpret_mode, cin, relu_in, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    x, k, b, ab = _inputs(cin * 10 + relu_in, cin)
    port = _port(x, k, b, ab if relu_in else None, tdt)

    xt = jnp.asarray(np.transpose(x, (0, 1, 3, 2)), jdt)  # NHWC -> NHCW
    args = (xt, convchain.kernel_matrix(jnp.asarray(k)), jnp.asarray(b), jnp.asarray(ab) if relu_in else None)
    for fn in (convchain.fused_conv_layer, convchain.reference_layer):
        y, s1, s2 = fn(*args, relu_in=relu_in)
        y = np.transpose(np.asarray(y, np.float32), (0, 1, 3, 2))  # NHCW -> NHWC
        _assert_close(port, (y, s1, s2))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False])
def test_layer_matches_nhwc_reference(dtype_name, relu_in):
    jdt, tdt = DTYPES[dtype_name]
    x, k, b, ab = _inputs(7 + relu_in, 16)
    port = _port(x, k, b, ab if relu_in else None, tdt)
    ref = convnhwc.reference_layer_nhwc(
        jnp.asarray(x, jdt), convnhwc.kernel_taps(jnp.asarray(k)), jnp.asarray(b),
        jnp.asarray(ab) if relu_in else None, relu_in=relu_in,
    )
    _assert_close(port, ref)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_layer_matches_fusedlayer_reference(dtype_name):
    """fusedlayer computes the same layer without a bias."""
    jdt, tdt = DTYPES[dtype_name]
    x, k, b, ab = _inputs(11, 8, bias=False)
    port = _port(x, k, b, ab, tdt)
    y, sums = fusedlayer.fused_layer_reference(
        jnp.asarray(x, jdt), jnp.asarray(k), jnp.asarray(ab[0]), jnp.asarray(ab[1])
    )
    _assert_close(port, (y, sums[0], sums[1]))


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor goes to the plain version, which launches nothing and
    stays differentiable."""
    x, k, b, _ = _inputs(3, 8)
    w = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()).requires_grad_()
    y, _, _ = tconvchain.fused_conv_layer(torch.from_numpy(x), w, torch.from_numpy(b))
    assert y.requires_grad
    assert tconvchain.launches == 0  # the plain version is no launch


def test_kernel_weight_layout():
    """The kernel's (9, Cin, Cout) weight layout is convnhwc's kernel_taps of
    the HWIO kernel."""
    _, k, _, _ = _inputs(5, 8)
    wk = tconvchain.kernel_weight(torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()), torch.float32)
    np.testing.assert_array_equal(wk.numpy(), np.asarray(convnhwc.kernel_taps(jnp.asarray(k))))
