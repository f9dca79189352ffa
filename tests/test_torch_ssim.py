"""The port's SSIM and its loss (pssr2_tpu_torch/ops/ssim.py,
ops/ssimfused.py, util.py) against the JAX package.

- ``ssimfused.reference_parts``, the plain version of the fused SSIM
  kernels, against the Pallas kernels ``ssimfused.fused_ssim_parts`` in
  interpret mode: the per-image (ssim, cs) means and their gradients.
- ``SSIMLoss(mix=0.8, ms=False)``: ``__call__``, ``per_sample`` and
  ``scaled(., ., 255)`` against the JAX class, with the JAX SSIM in its
  CPU path (XLA band matrices) and in its TPU path (the Pallas kernel,
  interpreted), values and input gradients; and ``SSIMLoss()``, whose
  default is MS-SSIM.

Tolerances: both sides compute in f32 with the same formulation; they
differ in the order of the blur sums and of the means.  The variance
terms ``E[x^2] - E[x]^2`` cancel, so means agree to 2e-6 and gradients to
1e-4 of their largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.ops.pallas import ssimfused
from pssr2_tpu.util import SSIMLoss as JaxSSIMLoss
from pssr2_tpu_torch.ops import ssimfused as tssimfused
from pssr2_tpu_torch.util import MSELoss, SSIMLoss

torch.set_num_threads(2)

MEAN_TOL, GRAD_TOL = 2e-6, 1e-4
# MS-SSIM's value: a product of five levels' means (measured within 2.6e-6)
MS_VALUE_TOL = 1e-5


@pytest.fixture
def interpret_mode():
    old = ssimfused.MODE
    ssimfused.MODE = "interpret"
    yield
    ssimfused.MODE = old


def _pair(shape, seed, scale=1.0):
    """A target in [0, scale] and a prediction near it, f32 numpy."""
    rng = np.random.default_rng(seed)
    y = rng.random(shape, np.float32) * scale
    x = (y + rng.normal(0, 0.1 * scale, shape)).astype(np.float32)
    return x, y


def _grad_close(got, ref):
    ref = np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    assert err <= GRAD_TOL * np.abs(ref).max(), f"max abs error {err} > {GRAD_TOL} * {np.abs(ref).max()}"


@pytest.mark.parametrize("shape", [(2, 1, 32, 32), (1, 2, 23, 40)])
def test_reference_parts_match_pallas(interpret_mode, shape):
    x, y = _pair(shape, 0)
    c1, c2 = 0.01**2, 0.03**2
    wts = np.random.default_rng(1).normal(0, 1, (2,) + shape[:2]).astype(np.float32)

    def jf(a, b):
        s, cs = ssimfused.fused_ssim_parts(a, b, c1, c2, 11, 1.5, interpret=True)
        return jnp.sum(s * wts[0]) + jnp.sum(cs * wts[1]), (s, cs)

    (_, (s_j, cs_j)), (gx_j, gy_j) = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(y)
    )
    xt, yt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(y).requires_grad_()
    s, cs = tssimfused.fused_ssim_parts(xt, yt, c1, c2, 11, 1.5)
    (torch.sum(s * torch.from_numpy(wts[0])) + torch.sum(cs * torch.from_numpy(wts[1]))).backward()
    assert s.shape == cs.shape == shape[:2]
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_j), rtol=0, atol=MEAN_TOL)
    np.testing.assert_allclose(cs.detach().numpy(), np.asarray(cs_j), rtol=0, atol=MEAN_TOL)
    _grad_close(xt.grad.numpy(), gx_j)
    _grad_close(yt.grad.numpy(), gy_j)


@pytest.mark.parametrize("mode", ["auto", "interpret"])
@pytest.mark.parametrize("how", ["call", "per_sample", "scaled"])
def test_ssim_loss_matches_jax(mode, how):
    old = ssimfused.MODE
    ssimfused.MODE = mode
    try:
        scale = 255.0 if how == "scaled" else 1.0
        x, y = _pair((2, 1, 48, 48), 3, scale)
        jloss, loss = JaxSSIMLoss(mix=0.8, ms=False), SSIMLoss(mix=0.8, ms=False)

        def jf(a):
            if how == "scaled":
                return jloss.scaled(a, jnp.asarray(y), 255)
            if how == "per_sample":
                return jnp.sum(jloss.per_sample(a, jnp.asarray(y)) * jnp.asarray([1.0, -2.0]))
            return jloss(a, jnp.asarray(y))

        val_j, g_j = jax.value_and_grad(jf)(jnp.asarray(x))
    finally:
        ssimfused.MODE = old
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y)
    if how == "scaled":
        val = loss.scaled(xt, yt, 255)
    elif how == "per_sample":
        per = loss.per_sample(xt, yt)
        assert per.shape == (2,)
        val = torch.sum(per * torch.tensor([1.0, -2.0]))
    else:
        val = loss(xt, yt)
    val.backward()
    assert abs(val.item() - float(val_j)) <= MEAN_TOL
    _grad_close(xt.grad.numpy(), g_j)


def test_default_ssim_loss_is_ms_ssim_and_matches_jax():
    """``SSIMLoss()`` defaults to ``ms=True`` on both sides: value and
    input gradient against the JAX class (JAX's CPU path), within
    MS_VALUE_TOL and GRAD_TOL (tests/test_torch_msssim.py covers the rest
    of MS-SSIM)."""
    x, y = _pair((2, 1, 192, 192), 5)
    loss = SSIMLoss()
    assert loss.ms and JaxSSIMLoss().ms
    val_j, g_j = jax.value_and_grad(lambda a: JaxSSIMLoss()(a, jnp.asarray(y)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    val = loss(xt, torch.from_numpy(y))
    val.backward()
    assert abs(val.item() - float(val_j)) <= MS_VALUE_TOL
    _grad_close(xt.grad.numpy(), g_j)


def test_mse_loss_matches_jax():
    from pssr2_tpu.util import MSELoss as JaxMSELoss

    x, y = _pair((3, 1, 8, 8), 4)
    np.testing.assert_allclose(
        MSELoss()(torch.from_numpy(x), torch.from_numpy(y)).item(), float(JaxMSELoss()(x, y)), rtol=1e-6
    )
    np.testing.assert_allclose(
        MSELoss().per_sample(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(JaxMSELoss().per_sample(x, y)), rtol=1e-6,
    )
