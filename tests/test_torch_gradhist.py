"""The port's soft histogram (pssr2_tpu_torch/ops/gradhist.py) on the CPU,
against the JAX package: the XLA formulation ``GradHist`` (forward and
``jax.grad``) and the Pallas kernels ``GradHistPallas`` in interpret mode,
at a ragged shape (2, 1, 40, 40) (N = 1600, not a multiple of the TPU
kernel's chunk, so its padding and bin-0 correction run) and at (3, 1,
64, 64).

Tolerances: the plain forward computes the XLA formulation in the same
order of operations, so against ``GradHist`` only torch's and XLA's
sigmoid and f32 sums differ: 5e-5 absolute per bin (masses up to ~66;
measured 7.6e-6).  The Pallas kernel telescopes sums of ~N sigmoids, so
it is held as JAX's own test holds it against the XLA form, 1e-3
(measured 3.2e-4).  Gradients: 1e-5 of the largest element against
``jax.grad`` of ``GradHist`` and of the Pallas kernel (measured 2.1e-7;
JAX's own test allows 1e-2 absolute between those two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.ops.gradhist import GradHist as JaxGradHist
from pssr2_tpu.ops.pallas.gradhist import GradHistPallas
from pssr2_tpu_torch.ops import gradhist

SHAPES = [(2, 1, 40, 40), (3, 1, 64, 64)]
FWD_TOL, FWD_PALLAS_TOL = 5e-5, 1e-3
GRAD_TOL = 1e-5


def _values(shape, seed):
    return np.random.default_rng(seed).normal(0, 30, shape).astype(np.float32)


def _cotangent(b, seed):
    return np.random.default_rng(seed).normal(0, 1, (b, 512)).astype(np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_jax(shape):
    x = _values(shape, 1)
    got = gradhist.GradHist(sigma=5)(torch.from_numpy(x)).numpy()
    assert got.shape == (shape[0], 512) and got.dtype == np.float32
    ref = np.asarray(JaxGradHist(sigma=5)(jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=FWD_TOL)
    pal = np.asarray(GradHistPallas(sigma=5, interpret=True)(jnp.asarray(x)))
    np.testing.assert_allclose(got, pal, rtol=0, atol=FWD_PALLAS_TOL)
    # the mass of a row is about its value count (values beyond the outer bins aside)
    np.testing.assert_allclose(got.sum(1), np.prod(shape[1:]), rtol=0.01)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gradient_matches_jax(shape):
    x, g = _values(shape, 2), _cotangent(shape[0], 3)
    xt = torch.from_numpy(x).requires_grad_()
    (gradhist.GradHist(sigma=5)(xt) * torch.from_numpy(g)).sum().backward()
    got = xt.grad.numpy()
    for fn in (JaxGradHist(sigma=5), GradHistPallas(sigma=5, interpret=True)):
        ref = np.asarray(jax.grad(lambda v: (fn(v) * jnp.asarray(g)).sum())(jnp.asarray(x)))
        assert np.abs(got - ref).max() <= GRAD_TOL * np.abs(ref).max()


def test_plain_backward_is_the_vjp_of_the_plain_forward():
    values = torch.from_numpy(_values((2, 300), 4)).double().float()
    centers = gradhist.bin_centers(64, (-64, 64))
    g = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 64)).astype(np.float32))
    v = values.clone().requires_grad_()
    (gradhist.gradhist_plain(v, centers, 2.0) * g).sum().backward()
    got = gradhist.gradhist_bwd_plain(values, centers, 2.0, g)
    assert (got - v.grad).abs().max() <= 1e-5 * v.grad.abs().max()


def test_bin_centers_and_factory():
    c = gradhist.bin_centers()
    assert c.dtype == torch.float32 and c.shape == (512,)
    assert c[0].item() == -255.5 and c[-1].item() == 255.5
    np.testing.assert_array_equal(c.numpy(), np.asarray(GradHistPallas(interpret=True).centers, np.float32))
    h = gradhist.make_gradhist(sigma=3)
    assert isinstance(h, gradhist.GradHist) and h.sigma == 3.0 and h.bins == 512
    with pytest.raises(ValueError):
        gradhist.bin_centers(8, (1, 1))


def test_cpu_takes_the_plain_version():
    before = (gradhist.launches, gradhist.bwd_launches)
    x = torch.zeros(2, 50, requires_grad=True)
    gradhist.GradHist()(x).sum().backward()
    assert (gradhist.launches, gradhist.bwd_launches) == before
