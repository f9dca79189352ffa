"""The port's MS-SSIM and its loss (pssr2_tpu_torch/ops/ssim.py,
ops/ssimfused.py, util.py) against the JAX package, on the CPU.

- The plain versions of the pool-level and level-0 kernels
  (``fused_ssim_parts_pool``, ``fused_level0_parts`` on CPU tensors)
  against the Pallas kernels in interpret mode, values and gradients with
  cotangents on every output.
- ``ms_ssim`` against JAX's in its CPU path (XLA band matrices) and its
  TPU path (the fused Pallas chain, interpreted), at 192^2, and at 200^2,
  whose odd pool sizes take the per-level chain on both sides.
- ``SSIMLoss(mix=0.8, ms=True)``: ``__call__``, ``per_sample`` and
  ``scaled(., ., 255)``, and the default ``SSIMLoss()``.
- The SSIM gate: a 7-tap window, and a bf16 loss, which takes the
  band-matrix path in bf16 on both sides.

Tolerances: both sides compute in f32 with the same formulation and
differ in the order of the blur sums, the pool's 4-term sums and the
means.  Measured: values within 2.6e-6, gradients within 2.7e-5 of their
largest magnitude.  Held to VALUE_TOL = 1e-5 and GRAD_TOL = 1e-4 (relative
to the largest JAX gradient).  bf16: see ``BF16_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.ops.ssim import _avg_pool2 as jax_avg_pool2
from pssr2_tpu.ops.ssim import ms_ssim as jax_ms_ssim
from pssr2_tpu.ops.pallas import ssimfused as jfused
from pssr2_tpu.util import SSIMLoss as JaxSSIMLoss
from pssr2_tpu_torch.ops import ssimfused
from pssr2_tpu_torch.ops.ssim import _avg_pool2, ms_ssim
from pssr2_tpu_torch.util import SSIMLoss, _psnr_metric

torch.set_num_threads(2)

VALUE_TOL, GRAD_TOL = 1e-5, 1e-4
C1, C2 = 0.01**2, 0.03**2


@pytest.fixture
def jax_mode(request):
    old = jfused.MODE
    jfused.MODE = request.param
    yield request.param
    jfused.MODE = old


def _pair(shape, seed, scale=1.0):
    """A target in [0, scale] and a prediction near it, f32 numpy."""
    rng = np.random.default_rng(seed)
    y = rng.random(shape, np.float32) * scale
    x = (y + rng.normal(0, 0.1 * scale, shape)).astype(np.float32)
    return x, y


def _close(got, ref, tol, rel=False):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    bound = tol * (np.abs(ref).max() if rel else 1.0)
    err = np.abs(got - ref).max()
    assert err <= bound, f"max abs error {err} > {bound}"


def _weights(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("shape", [(2, 1, 192, 192), (3, 1, 64, 96)], ids=lambda s: "x".join(map(str, s)))
def test_pool_level_plain_matches_pallas(shape):
    """Row 4's plain version: (ssim, cs) means, pooled maps and gradients
    with cotangents on all four outputs."""
    x, y = _pair(shape, 0)
    half = (*shape[:2], shape[2] // 2, shape[3] // 2)
    ws = _weights([shape[:2], shape[:2], half, half], 1)

    def jf(a, b):
        outs = jfused.fused_ssim_parts_pool(a, b, C1, C2, 11, 1.5, interpret=True)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    (_, outs_j), (gx_j, gy_j) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(y))
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    outs = ssimfused.fused_ssim_parts_pool(xt, yt, C1, C2, 11, 1.5)
    sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(outs, ws)).backward()
    for got, ref in zip(outs, outs_j):
        _close(got, ref, VALUE_TOL)
    _close(xt.grad, gx_j, GRAD_TOL, rel=True)
    _close(yt.grad, gy_j, GRAD_TOL, rel=True)


@pytest.mark.parametrize("divisor", [1.0, 255.0])
def test_level0_plain_matches_pallas(divisor):
    """Row 3's plain version: the divide, (ssim, cs), the windowed-L1 mean
    and the pooled maps, and gradients with cotangents on all five outputs
    (the L1 gradient is the closed form on the JAX side, autograd of the
    blur here)."""
    shape = (2, 1, 192, 192)
    x, y = _pair(shape, 2, scale=divisor)
    half = (*shape[:2], 96, 96)
    ws = _weights([shape[:2]] * 3 + [half, half], 3)

    def jf(a, b):
        outs = jfused.fused_level0_parts(a, b, C1, C2, 11, 1.5, divisor, interpret=True)
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws)), outs

    (_, outs_j), (gx_j, gy_j) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(y))
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    outs = ssimfused.fused_level0_parts(xt, yt, C1, C2, 11, 1.5, divisor)
    sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(outs, ws)).backward()
    for got, ref in zip(outs, outs_j):
        _close(got, ref, VALUE_TOL)
    _close(xt.grad, gx_j, GRAD_TOL, rel=True)
    _close(yt.grad, gy_j, GRAD_TOL, rel=True)


@pytest.mark.parametrize("jax_mode", ["auto", "interpret"], indirect=True)
@pytest.mark.parametrize("shape", [(2, 1, 192, 192), (3, 1, 200, 200)], ids=lambda s: "x".join(map(str, s)))
def test_ms_ssim_matches_jax(jax_mode, shape):
    """Value and input gradient of ms_ssim (data_range 1 and 255): 192^2
    takes the fused chain's plain versions here (and JAX's interpreted
    kernels in interpret mode); 200^2 pools to odd sizes and takes the
    per-level chain on both sides."""
    for data_range in (1.0, 255.0):
        x, y = _pair(shape, 4, scale=data_range)
        val_j, g_j = jax.value_and_grad(lambda a: jax_ms_ssim(a, jnp.asarray(y), data_range=data_range))(
            jnp.asarray(x)
        )
        xt = torch.from_numpy(x).requires_grad_()
        val = ms_ssim(xt, torch.from_numpy(y), data_range=data_range)
        val.backward()
        assert abs(val.item() - float(val_j)) <= VALUE_TOL
        _close(xt.grad, g_j, GRAD_TOL, rel=True)
    per = ms_ssim(torch.from_numpy(x), torch.from_numpy(y), data_range=255.0, size_average=False)
    _close(per, jax_ms_ssim(jnp.asarray(x), jnp.asarray(y), data_range=255.0, size_average=False), VALUE_TOL)


def test_ms_ssim_refuses_small_images():
    x = torch.zeros(1, 1, 160, 200)
    with pytest.raises(ValueError, match="too small"):
        ms_ssim(x, x)


@pytest.mark.parametrize("shape", [(1, 2, 7, 9), (2, 1, 8, 8), (1, 1, 5, 6)])
def test_avg_pool2_matches_jax(shape):
    x = np.random.default_rng(5).normal(0, 1, shape).astype(np.float32)
    _close(_avg_pool2(torch.from_numpy(x)), jax_avg_pool2(jnp.asarray(x)), 1e-7)


@pytest.mark.parametrize("jax_mode", ["auto", "interpret"], indirect=True)
@pytest.mark.parametrize("how", ["call", "per_sample", "scaled", "default"])
def test_ms_ssim_loss_matches_jax(jax_mode, how):
    """SSIMLoss(mix=0.8, ms=True) (and SSIMLoss(), whose default is
    ms=True) against the JAX class: values and input gradients.  In JAX's
    interpret mode its loss takes the fused chain (level 0 with the L1
    closed form, the pool levels, the last level)."""
    scale = 255.0 if how == "scaled" else 1.0
    x, y = _pair((2, 1, 192, 192), 6, scale)
    jloss, loss = (JaxSSIMLoss(), SSIMLoss()) if how == "default" else (JaxSSIMLoss(mix=0.8, ms=True), SSIMLoss(mix=0.8, ms=True))
    signs = np.asarray([1.0, -2.0], np.float32)

    def jf(a):
        if how == "scaled":
            return jloss.scaled(a, jnp.asarray(y), 255)
        if how == "per_sample":
            return jnp.sum(jloss.per_sample(a, jnp.asarray(y)) * signs)
        return jloss(a, jnp.asarray(y))

    val_j, g_j = jax.value_and_grad(jf)(jnp.asarray(x))
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y)
    if how == "scaled":
        val = loss.scaled(xt, yt, 255)
    elif how == "per_sample":
        per = loss.per_sample(xt, yt)
        assert per.shape == (2,)
        val = torch.sum(per * torch.from_numpy(signs))
    else:
        val = loss(xt, yt)
    val.backward()
    assert abs(val.item() - float(val_j)) <= VALUE_TOL
    _close(xt.grad, g_j, GRAD_TOL, rel=True)


@pytest.mark.parametrize("ms", [False, True], ids=["ssim", "ms_ssim"])
def test_loss_with_window_7_matches_jax(ms):
    """A 7-tap window: the kernels take it on the card; here the plain
    versions against the JAX band path."""
    x, y = _pair((2, 1, 128, 128), 7)
    jloss, loss = JaxSSIMLoss(win_size=7, ms=ms), SSIMLoss(win_size=7, ms=ms)
    val_j, g_j = jax.value_and_grad(lambda a: jloss(a, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    val = loss(xt, torch.from_numpy(y))
    val.backward()
    assert abs(val.item() - float(val_j)) <= VALUE_TOL
    _close(xt.grad, g_j, GRAD_TOL, rel=True)


# bf16 losses: both sides blur in bf16 band matrices and form the moments
# and the SSIM maps in bf16, rounding in different places (XLA's CPU dots
# and torch's bf16 matmul differ in where they round), so the loss values
# agree to a few bf16 ulps at 1 (2^-8 = 0.0039 each).
BF16_TOL = 0.02


@pytest.mark.parametrize("ms", [False, True], ids=["ssim", "ms_ssim"])
def test_bf16_loss_takes_band_path_and_matches_jax(ms):
    x, y = _pair((2, 1, 192, 192), 8)
    jval = float(JaxSSIMLoss(ms=ms, dtype=jnp.bfloat16)(jnp.asarray(x), jnp.asarray(y)))
    f32 = float(JaxSSIMLoss(ms=ms)(jnp.asarray(x), jnp.asarray(y)))
    val = SSIMLoss(ms=ms, dtype=torch.bfloat16)(torch.from_numpy(x), torch.from_numpy(y))
    assert val.dtype == torch.bfloat16
    assert not ssimfused.auto_ok(torch.from_numpy(x).bfloat16(), 11)
    assert abs(val.float().item() - jval) <= BF16_TOL
    assert abs(val.float().item() - f32) <= BF16_TOL


def test_gate_matches_jax_dispatch():
    """The port's gate takes f32 maps with an odd window no larger than the
    image; bf16 maps, even windows and images smaller than the window take
    the band path (JAX's auto_ok on its TPU path: f32, image at least the
    window)."""
    x = torch.zeros(1, 1, 16, 16)
    assert ssimfused.auto_ok(x, 11) and ssimfused.auto_ok(x, 15)
    assert not ssimfused.auto_ok(x.bfloat16(), 11)
    assert not ssimfused.auto_ok(x, 10)
    assert not ssimfused.auto_ok(x, 17)
    assert ssimfused.auto_ok(torch.zeros(1, 1, 64, 64), ssimfused.MAX_WIN + 2)  # the kernel refuses it


def test_psnr_metric_matches_jax():
    from pssr2_tpu.util import _psnr_metric as jpsnr

    for mse in (1e-4, 0.01, 0.3):
        assert _psnr_metric(mse) == pytest.approx(float(jpsnr(mse)), rel=1e-12)
