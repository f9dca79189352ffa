"""The port's per-channel dual sums (pssr2_tpu_torch/ops/chanstats.py) and
where they run, on the CPU, against the JAX package:

- the plain ``dual_sums`` against JAX's ``dual_sums(force="interpret")``
  (the Pallas kernel interpreted) and ``_dual_sums_jnp``, f32 and bf16,
  including C = 1 (the input BatchNorm) and ragged row counts;
- train-mode BatchNorm, whose forward and backward sums are dual sums now,
  against JAX's ``bn_train`` (values and its VJP);
- a train-mode ``ResBlock``, whose last layer's affine backward takes
  [sum gy, sum gy h] from ``dual_sums``, against the JAX ResBlock: output,
  the input's gradient and every parameter's gradient (``nnx.grad``).

Tolerances: the sums differ only in the order of f32 additions, so 1e-6
of the channel's sum of magnitudes (bf16 products are exact in f32).  The
BatchNorm and the ResBlock are held to 1e-5 of the largest element in f32
(measured about 1e-6) and, for the ResBlock, 1e-5 for the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pssr2_tpu.models.blocks import ResBlock as JaxResBlock
from pssr2_tpu.ops import batchnorm as jbatchnorm
from pssr2_tpu.ops.pallas.chanstats import _dual_sums_jnp
from pssr2_tpu.ops.pallas.chanstats import dual_sums as jax_dual_sums
from pssr2_tpu_torch.models.blocks import ResBlock
from pssr2_tpu_torch.ops import chanstats
from pssr2_tpu_torch.ops.batchnorm import bn_train

torch.set_num_threads(2)

SUM_TOL, OUT_TOL, GRAD_TOL = 1e-6, 1e-5, 1e-5
CASES = [(4096, 64, "bf16"), (1024, 96, "f32"), (520, 5, "f32"), (1600, 1, "f32"), (64, 1024, "bf16")]


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("rows,c,dt", CASES, ids=lambda v: str(v))
def test_dual_sums_match_jax(rows, c, dt):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.default_rng(rows + c)
    x = jnp.asarray(rng.random((rows, c), np.float32) - 0.3, dtype=jdt)
    y = jnp.asarray(rng.normal(0, 1, (rows, c)).astype(np.float32), dtype=jdt)
    xt, yt = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt) for a in (x, y))
    got = chanstats.dual_sums(xt, yt)
    assert got.shape == (2, c) and got.dtype == torch.float32
    mags = chanstats.dual_sums_plain(xt.abs(), yt.abs()).numpy()
    for ref in (_dual_sums_jnp(x, y), jax_dual_sums(x, y, force="interpret")):
        assert (np.abs(got.numpy() - np.asarray(ref)) <= SUM_TOL * mags).all()
    err, ratio = chanstats.errors(got, xt, yt)
    assert err == 0.0 and ratio == 0.0  # the plain version is the reference of errors()
    # the channels-last helper is the same sums over every axis but the last
    x4 = xt.view(1, rows, 1, c)
    assert torch.equal(chanstats.channel_sums(x4, x4), chanstats.dual_sums(xt, xt))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("c", [1, 6])
def test_bn_train_with_dual_sums_matches_jax(dtype_name, c):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    rng = np.random.default_rng(c)
    x = rng.normal(0.5, 2.0, (3, 5, 7, c)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.normal(0, 0.3, c).astype(np.float32)
    gy = rng.normal(0, 1, x.shape).astype(np.float32)
    (y_j, mu_j, var_j), vjp = jax.vjp(
        lambda a, s, b: jbatchnorm.bn_train(a, s, b, 1e-5), jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias)
    )
    gx_j, gs_j, gb_j = vjp((jnp.asarray(gy, jdt), jnp.zeros(c), jnp.zeros(c)))

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st, bt = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y, mu, var = bn_train(xt, st, bt, 1e-5)
    y.backward(torch.from_numpy(gy).to(tdt))
    out_tol = OUT_TOL if dtype_name == "f32" else 1 / 128
    assert _rel_err(y.float().detach(), y_j) <= out_tol and _rel_err(xt.grad.float(), gx_j) <= out_tol
    assert _rel_err(mu.detach(), mu_j) <= OUT_TOL and _rel_err(var.detach(), var_j) <= OUT_TOL
    assert _rel_err(st.grad, gs_j) <= OUT_TOL and _rel_err(bt.grad, gb_j) <= OUT_TOL


def _copy_resblock(jblk, blk):
    """The JAX ResBlock's parameters and statistics into the port's."""
    with torch.no_grad():
        for i in range(jblk.n_layers):
            cv, bn = blk.conv[3 * i], blk.conv[3 * i + 1]
            cv.weight.copy_(torch.from_numpy(np.asarray(jblk.convs[i].kernel[...]).transpose(3, 2, 0, 1).copy()))
            cv.bias.copy_(torch.from_numpy(np.asarray(jblk.convs[i].bias[...])))
            jbn = jblk.norms[i]
            for name, jname in (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"), ("running_var", "var")):
                getattr(bn, name).copy_(torch.from_numpy(np.asarray(getattr(jbn, jname)[...])))
        blk.respass.weight.copy_(torch.from_numpy(np.asarray(jblk.respass.kernel[...]).transpose(3, 2, 0, 1).copy()))
        blk.respass.bias.copy_(torch.from_numpy(np.asarray(jblk.respass.bias[...])))


def test_train_resblock_matches_jax_gradients():
    """The last layer's affine backward (dual sums of gy and h) inside a
    train-mode ResBlock: output, dx and every parameter gradient."""
    cin, cout, depth = 8, 16, 1
    jblk = JaxResBlock(cin, cout, depth, rngs=nnx.Rngs(3))
    rng = np.random.default_rng(4)
    for i in range(jblk.n_layers):  # non-trivial affines, so the sums matter
        jblk.norms[i].scale[...] = jnp.asarray(rng.uniform(0.5, 1.5, cout).astype(np.float32))
        jblk.norms[i].bias[...] = jnp.asarray(rng.normal(0, 0.3, cout).astype(np.float32))
    blk = ResBlock(cin, cout, depth, device="cpu")
    _copy_resblock(jblk, blk)
    x = rng.normal(0, 1, (2, 9, 11, cin)).astype(np.float32)
    g = rng.normal(0, 1, (2, 9, 11, cout)).astype(np.float32)

    jblk.train()

    def loss(m, v):
        y = m(v)
        return (y * jnp.asarray(g)).sum(), y

    (_, y_j), (grads_j, gx_j) = nnx.value_and_grad(loss, argnums=(0, 1), has_aux=True)(jblk, jnp.asarray(x))

    blk.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = blk(xt)
    (y * torch.from_numpy(g)).sum().backward()
    assert _rel_err(y.detach(), y_j) <= OUT_TOL
    assert _rel_err(xt.grad, gx_j) <= GRAD_TOL
    for i in range(jblk.n_layers):
        cv, bn = blk.conv[3 * i], blk.conv[3 * i + 1]
        assert _rel_err(cv.weight.grad, np.asarray(grads_j["convs"][i]["kernel"][...]).transpose(3, 2, 0, 1)) <= GRAD_TOL
        assert _rel_err(bn.weight.grad, grads_j["norms"][i]["scale"][...]) <= GRAD_TOL
        assert _rel_err(bn.bias.grad, grads_j["norms"][i]["bias"][...]) <= GRAD_TOL
        # the conv bias under train-mode BatchNorm: stop-gradient on both sides
        assert cv.bias.grad is None and not np.asarray(grads_j["convs"][i]["bias"][...]).any()
    assert _rel_err(blk.respass.weight.grad, np.asarray(grads_j["respass"]["kernel"][...]).transpose(3, 2, 0, 1)) \
        <= GRAD_TOL
    assert _rel_err(blk.respass.bias.grad, grads_j["respass"]["bias"][...]) <= GRAD_TOL


def test_cpu_takes_the_plain_version():
    before = chanstats.launches
    x = torch.ones(10, 3)
    assert torch.equal(chanstats.dual_sums(x, 2 * x), torch.tensor([[10.0] * 3, [20.0] * 3]))
    assert chanstats.launches == before
