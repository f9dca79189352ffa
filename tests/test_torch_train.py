"""The port's training slice (pssr2_tpu_torch: train-mode BatchNorm, the
device pipeline, AdamW and the train step) against the JAX package.

- BatchNorm: ``bn_train`` (values, gradients) and the train branch of
  ``apply_coeffs`` (coefficients, gradients into the sums, running
  statistics) against ``ops/batchnorm.bn_train`` and ``FastBatchNorm``.
  f32 to 1e-5 relative; bf16 within one bf16 ulp of the output (1/128 of
  its magnitude), and f32 statistics to 1e-5 relative.
- Device pipeline: the downscale to 1e-3 on the [0, 255] scale, the uint8
  rounding and the augmentation for a given draw exactly; the Poisson
  noise by its mean and variance against the law of
  ``ops/degrade.poisson`` (``x (1 - mix) + Poisson(x) mix + gain``).
- AdamW: steps against ``optax.adamw`` to 1e-6 relative, a parameter with
  an all-zero gradient included (it must still decay).
- The whole step: ``ResUNet(hidden=[8, 16], depth=1)`` in train mode, 64^2
  HR from 16^2 LR, batch 2, ``SSIMLoss(mix=0.8, ms=False)``, AdamW, from
  the same weights and the same (hr, lr) pair through the JAX
  ``_build_paired_steps(loss, False, None)`` and the port's.  Bounds are
  stated at ``STEP_TOL``.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from pssr2_tpu.checkpoint import _flatten_state, load_weights
from pssr2_tpu.data import pipeline as jpipeline
from pssr2_tpu.models import ResUNet as JaxResUNet
from pssr2_tpu.ops import batchnorm as jbatchnorm
from pssr2_tpu.ops import resize as jresize
from pssr2_tpu.optim import AdamW as JaxAdamW
from pssr2_tpu.train import _build_paired_steps as jax_build_paired_steps
from pssr2_tpu.util import SSIMLoss as JaxSSIMLoss
from pssr2_tpu_torch import Poisson
from pssr2_tpu_torch.data import pipeline
from pssr2_tpu_torch.models import ResUNet
from pssr2_tpu_torch.ops import degrade, resize
from pssr2_tpu_torch.ops.batchnorm import BatchNorm, bn_train
from pssr2_tpu_torch.optim import AdamW
from pssr2_tpu_torch.train import _build_multi_train_step, _build_paired_steps
from pssr2_tpu_torch.util import SSIMLoss
from pssr2_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

HIDDEN, DEPTH, LR_RATE = [8, 16], 1, 1e-3


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    scale = np.abs(ref).max()
    return np.abs(got - ref).max() / scale if scale else np.abs(got).max()


# ---- BatchNorm --------------------------------------------------------------


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_bn_train_matches_jax(dtype_name):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype_name]
    rng = np.random.default_rng(0)
    x = rng.normal(0.5, 2.0, (3, 5, 7, 6)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 6).astype(np.float32), rng.normal(0, 0.3, 6).astype(np.float32)
    gy = rng.normal(0, 1, x.shape).astype(np.float32)
    (y_j, mu_j, var_j), vjp = jax.vjp(
        lambda a, s, b: jbatchnorm.bn_train(a, s, b, 1e-5), jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias)
    )
    gx_j, gs_j, gb_j = vjp((jnp.asarray(gy, jdt), jnp.zeros(6), jnp.zeros(6)))

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st, bt = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    y, mu, var = bn_train(xt, st, bt, 1e-5)
    y.backward(torch.from_numpy(gy).to(tdt))
    assert y.dtype == xt.grad.dtype == tdt
    out_tol = 1e-5 if dtype_name == "f32" else 1 / 128
    assert _rel_err(y.float().detach(), y_j) <= out_tol
    assert _rel_err(mu.detach(), mu_j) <= 1e-5 and _rel_err(var.detach(), var_j) <= 1e-5
    assert _rel_err(xt.grad.float(), gx_j) <= out_tol
    assert _rel_err(st.grad, gs_j) <= 1e-5 and _rel_err(bt.grad, gb_j) <= 1e-5


def _jax_bn(c, scale, bias, mean, var):
    bn = jbatchnorm.FastBatchNorm(c)
    for name, value in (("scale", scale), ("bias", bias), ("mean", mean), ("var", var)):
        getattr(bn, name)[...] = jnp.asarray(value)
    return bn


def _port_bn(c, scale, bias, mean, var):
    bn = BatchNorm(c)
    with torch.no_grad():
        for name, value in (("weight", scale), ("bias", bias), ("running_mean", mean), ("running_var", var)):
            getattr(bn, name).copy_(torch.from_numpy(value))
    return bn.train()


@pytest.mark.parametrize("seam", ["call", "apply_coeffs"])
def test_batchnorm_module_train_mode_matches_fastbatchnorm(seam):
    """The module in train mode, as ``__call__`` and as the kernel seam
    ``apply_coeffs(s1, s2, count)``: values, gradients (into the sums for
    the seam) and the running statistics after the call."""
    rng = np.random.default_rng(1)
    c = 5
    x = rng.normal(0.2, 1.5, (4, 6, 6, c)).astype(np.float32)
    stats = [rng.uniform(0.5, 1.5, c), rng.normal(0, 0.2, c), rng.normal(0, 0.1, c), rng.uniform(0.5, 1.5, c)]
    stats = [s.astype(np.float32) for s in stats]
    s1, s2, count = x.sum((0, 1, 2)), (x * x).sum((0, 1, 2)), 4 * 6 * 6
    w = rng.normal(0, 1, (2, c)).astype(np.float32)
    gy = rng.normal(0, 1, x.shape).astype(np.float32)

    jbn = _jax_bn(c, *stats)
    if seam == "call":

        def jf(m, a):
            return jnp.sum(m(a) * gy)

        args = (jnp.asarray(x),)
    else:

        def jf(m, a, b):
            ca, cb = m.apply_coeffs(a, b, count)
            return jnp.sum(ca * w[0]) + jnp.sum(cb * w[1])

        args = (jnp.asarray(s1), jnp.asarray(s2))
    val_j, grads = nnx.value_and_grad(jf, argnums=tuple(range(1 + len(args))))(jbn, *args)
    module_grads = nnx.to_pure_dict(grads[0])
    grads_j = [module_grads["scale"], module_grads["bias"], *grads[1:]]

    bn = _port_bn(c, *stats)
    targs = [torch.from_numpy(a).requires_grad_() for a in ((x,) if seam == "call" else (s1, s2))]
    if seam == "call":
        val = torch.sum(bn(targs[0]) * torch.from_numpy(gy))
    else:
        ca, cb = bn.apply_coeffs(targs[0], targs[1], count)
        val = torch.sum(ca * torch.from_numpy(w[0])) + torch.sum(cb * torch.from_numpy(w[1]))
    val.backward()
    assert abs(val.item() - float(val_j)) <= 1e-5 * max(1.0, abs(float(val_j)))
    for got, ref in zip([bn.weight.grad, bn.bias.grad] + [t.grad for t in targs], grads_j):
        assert _rel_err(got, ref) <= 1e-5
    # running statistics: momentum 0.9 and the biased variance, once per call
    assert _rel_err(bn.running_mean, jbn.mean[...]) <= 1e-6
    assert _rel_err(bn.running_var, jbn.var[...]) <= 1e-6


def test_batchnorm_eval_mode_takes_running_stats():
    rng = np.random.default_rng(2)
    stats = [rng.uniform(0.5, 1.5, 3), rng.normal(0, 0.2, 3), rng.normal(0, 0.1, 3), rng.uniform(0.5, 1.5, 3)]
    bn = _port_bn(3, *[s.astype(np.float32) for s in stats]).eval()
    before = bn.running_mean.clone()
    x = torch.from_numpy(rng.normal(0, 1, (2, 4, 4, 3)).astype(np.float32))
    a = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    torch.testing.assert_close(bn(x), x * a + (bn.bias - bn.running_mean * a), rtol=0, atol=0)
    torch.testing.assert_close(bn.running_mean, before, rtol=0, atol=0)


# ---- the device pipeline -----------------------------------------------------


def _hr_u8(b=2, res=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, 1, res, res)).astype(np.uint8)


def test_downscale_and_rounding_match_jax():
    hr = _hr_u8()
    down = resize.resize_bilinear(torch.from_numpy(hr).float(), 16, 16)
    down_j = jresize.resize_bilinear(jnp.asarray(hr, jnp.float32), 16, 16)
    np.testing.assert_allclose(down.numpy(), np.asarray(down_j), rtol=0, atol=1e-3)

    hr_t, lr_t = pipeline.make_device_gen_pair(4, None, augment=False)(torch.Generator(), torch.from_numpy(hr))
    hr_j, lr_j = jpipeline.make_device_gen_pair(4, None, augment=False)(jax.random.key(0), jnp.asarray(hr))
    assert hr_t.dtype == lr_t.dtype == torch.float32 and lr_t.shape == (2, 1, 16, 16)
    np.testing.assert_array_equal(hr_t.numpy(), np.asarray(hr_j))
    np.testing.assert_array_equal(lr_t.numpy(), np.asarray(lr_j))


def test_augment_matches_jax_for_each_draw():
    """For keys whose draws cover every (rot90, flip) choice, the port's
    augmentation of that choice equals the JAX augmentation exactly."""
    x = _hr_u8(1, 8, 3)[0]
    seen = set()
    for seed in range(40):
        if len(seen) == 6:
            break
        key = jax.random.key(seed)
        k1, k2 = jax.random.split(key)
        rot, choice = bool(jax.random.bernoulli(k1)), int(jax.random.randint(k2, (), 0, 3))
        seen.add((rot, choice))
        ref = np.asarray(jpipeline.device_augment(key, jnp.asarray(x)))
        got = pipeline._augment(torch.from_numpy(x)[None], torch.tensor([rot]), torch.tensor([choice]))
        np.testing.assert_array_equal(got[0].numpy(), ref)
    assert len(seen) == 6


def test_device_augment_draws_every_choice():
    x = torch.from_numpy(_hr_u8(400, 4, 4))
    out = pipeline.device_augment(torch.Generator().manual_seed(0), x)
    kinds = set()
    for i in range(len(x)):
        for rot in (False, True):
            for choice in range(3):
                if torch.equal(out[i : i + 1], pipeline._augment(x[i : i + 1], torch.tensor([rot]), torch.tensor([choice]))):
                    kinds.add((rot, choice))
    assert len(kinds) == 6


def test_patch_loader_and_hr_patch_match_jax(tmp_path):
    """``ImageDataset.hr_patch`` gives the JAX package's uint8 patch (crop
    and reflect-pad), and ``PatchLoader`` batches them in sampler order,
    padding the last batch by repeating its last sample."""
    from pssr2_tpu.data import tiff as jtiff
    from pssr2_tpu.data.datasets import ImageDataset as JaxImageDataset
    from pssr2_tpu_torch.data import ImageDataset

    rng = np.random.default_rng(6)
    for i, shape in enumerate([(40, 40), (48, 36), (32, 32)]):
        jtiff.imwrite(tmp_path / f"im_{i}.tif", rng.integers(0, 256, shape).astype(np.uint8))
    kwargs = dict(hr_res=40, lr_scale=4, val_split=1)
    ours, theirs = ImageDataset(tmp_path, **kwargs), JaxImageDataset(tmp_path, **kwargs)
    for i in range(3):
        patch = ours.hr_patch(i)
        assert patch.dtype == np.uint8 and patch.shape == (1, 40, 40)
        np.testing.assert_array_equal(patch, theirs.hr_patch(i))
    batches = list(pipeline.PatchLoader(ours, [2, 0, 1], batch_size=2, num_workers=2))
    assert [n for _, n in batches] == [2, 1]
    np.testing.assert_array_equal(batches[0][0], np.stack([ours.hr_patch(2), ours.hr_patch(0)]))
    np.testing.assert_array_equal(batches[1][0], np.stack([ours.hr_patch(1)] * 2))


@pytest.mark.parametrize("intensity, gain", [(1.0, 0.0), (0.5, 3.0)])
def test_poisson_follows_its_law(intensity, gain):
    """Mean x + gain and variance mix^2 x per pixel, for each of a few
    levels x, within 5 standard errors of a 20000-pixel sample."""
    levels = torch.tensor([0.0, 2.0, 17.0, 130.0])
    images = levels.view(4, 1, 1, 1).expand(4, 1, 100, 200).contiguous()
    out = degrade.poisson(torch.Generator().manual_seed(0), images, intensity=intensity, gain=gain)
    n = 100 * 200
    for lam, o in zip(levels.tolist(), out):
        var = intensity**2 * lam
        assert abs(o.mean().item() - (lam + gain)) <= 5 * np.sqrt(var / n) + 1e-6
        assert abs(o.var().item() - var) <= 5 * var * np.sqrt(2 / n + 1 / (n * max(lam, 1))) + 1e-6


def test_poisson_intensity_spread():
    draws = degrade._draw_intensity(torch.Generator().manual_seed(1), 1.0, 0.5, 20000, "cpu")
    assert draws.min().item() >= 0.0
    assert abs(draws.mean().item() - 1.0) < 0.02  # max(N(1, 0.5), 0): mean 1.0043
    assert degrade.to_device_fn(Poisson(intensity=2, gain=1)).keywords == {"intensity": 2, "gain": 1, "spread": 0}


def test_gen_pair_with_poisson_gives_integer_pairs():
    gen_pair = pipeline.make_device_gen_pair(4, Poisson())
    hr, lr = gen_pair(torch.Generator().manual_seed(0), torch.from_numpy(_hr_u8()))
    assert hr.shape == (2, 1, 64, 64) and lr.shape == (2, 1, 16, 16)
    assert torch.equal(lr, lr.round()) and lr.min() >= 0 and lr.max() <= 255


# ---- AdamW -------------------------------------------------------------------


def test_adamw_matches_optax():
    """Three steps on two parameters, one of them with an all-zero gradient
    each step: torch's AdamW with the gradient given as zeros (the train
    step's rule) decays it as optax does."""
    rng = np.random.default_rng(5)
    params = {"w": rng.normal(0, 1, (4, 3)).astype(np.float32), "b": rng.normal(0, 1, 3).astype(np.float32)}
    grads = [{"w": rng.normal(0, 1e-2, (4, 3)).astype(np.float32), "b": np.zeros(3, np.float32)} for _ in range(3)]

    tx = JaxAdamW(LR_RATE).tx
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = AdamW(LR_RATE).init(list(tp.values()))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8)
    assert not np.allclose(np.asarray(jp["b"]), params["b"])  # the zero-gradient parameter decayed


# ---- the whole step ------------------------------------------------------------

# Port step against the JAX step, from the same weights and (hr, lr) pair:
# loss (abs), hr_hat (abs, [0, 255] scale), each gradient (max abs error
# over max |JAX gradient| of that parameter), all gradients together
# (norm of the error over the norm of the JAX gradients), parameters after
# the AdamW step (abs) and the share of their elements whose step differs
# by more than LR_RATE / 2 (the first Adam step moves an element by about
# LR_RATE, with the sign of its gradient), running statistics (relative).
# f32: only the order of f32 sums differs.  bf16: activations round to 8
# bits after every layer and the two packages round in different places
# (the port's BatchNorm affine once, as the TPU kernel chain does), which
# moves the gradients about as far as bf16 itself moves JAX's: all
# gradients together are held to twice the distance between JAX's bf16 and
# f32 gradients ("grads" is that factor in bf16), each parameter's to 25%
# of its largest element, and a step may move an element whose gradient is
# near zero the other way (2 LR_RATE).
STEP_TOL = {
    "f32": {"loss": 1e-5, "hr_hat": 2e-3, "grad": 1e-3, "grads": 1e-4, "param": 2e-5, "flips": 0.0, "stat": 1e-5},
    "bf16": {"loss": 5e-3, "hr_hat": 8.0, "grad": 0.25, "grads": 2.0, "param": 2.001 * LR_RATE, "flips": 0.05,
             "stat": 2e-2},
}


def _models(dtype_name, tmp_path, seed=0):
    jdt = jnp.bfloat16 if dtype_name == "bf16" else None
    jmodel = JaxResUNet(hidden=HIDDEN, depth=DEPTH, dtype=jdt)
    flat = _flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState)))
    rng = np.random.default_rng(seed)
    for key, value in flat.items():  # BatchNorm statistics that do work
        if "norm" in key and key.endswith(("/mean", "/bias")):
            flat[key] = rng.normal(0, 0.2, value.shape).astype(np.float32)
        elif key.endswith(("/var", "/scale")):
            flat[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
    np.savez(tmp_path / "weights.npz", **flat)
    load_weights(jmodel, str(tmp_path / "weights.npz"))
    model = ResUNet(hidden=HIDDEN, depth=DEPTH, dtype=torch.bfloat16 if jdt else None, device="cpu")
    model.load_state_dict(params_from_jax(flat), strict=True)
    jmodel.train()
    model.train()
    return jmodel, model


def _pair(seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:64]
    hr = np.stack([127 + 100 * np.sin(xx / (3 + i)) * np.cos(yy / (4 + i)) for i in range(2)])[:, None]
    hr = np.clip(np.round(hr + rng.normal(0, 8, hr.shape)), 0, 255).astype(np.float32)
    lr = np.clip(np.round(np.asarray(jresize.resize_bilinear(jnp.asarray(hr), 16, 16))), 0, 255)
    return hr, np.asarray(lr, np.float32)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_train_step_matches_jax(dtype_name, tmp_path):
    tol = STEP_TOL[dtype_name]
    jmodel, model = _models(dtype_name, tmp_path)
    hr, lr = _pair()
    jloss = JaxSSIMLoss(mix=0.8, ms=False)

    # JAX gradients, on a second model from the same weights (its forward
    # updates its own running statistics)
    def jax_grads(name):
        jmodel_g, _ = _models(name, tmp_path)
        grads = nnx.grad(lambda m: jloss.scaled(m(jnp.asarray(lr)), jnp.asarray(hr), 255))(jmodel_g)
        return params_from_jax(_flatten_state(grads))

    grads_j = jax_grads(dtype_name)

    # the JAX step and the port's step
    optim_j = JaxAdamW(LR_RATE)
    optimizer_j = nnx.Optimizer(jmodel, optim_j.tx, wrt=nnx.Param)
    step_j, _ = jax_build_paired_steps(jloss, False, None)
    loss_j, _, (_, hr_hat_j, _) = step_j(
        jmodel, optimizer_j, (jnp.asarray(hr), jnp.asarray(lr)), None, jax.random.key(0), optim_j.lr, 2, False
    )
    after_j = params_from_jax(_flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState))))

    optimizer = AdamW(LR_RATE).init(model.parameters())
    step, _ = _build_paired_steps(SSIMLoss(mix=0.8, ms=False), False, None)
    loss, metrics, (_, hr_hat, _) = step(
        model, optimizer, (torch.from_numpy(hr), torch.from_numpy(lr)), None, None, LR_RATE, 2, False
    )
    assert metrics is None and hr_hat.shape == (2, 1, 64, 64)

    assert abs(loss.item() - float(loss_j)) <= tol["loss"]
    assert np.abs(hr_hat.numpy() - np.asarray(hr_hat_j, np.float32)).max() <= tol["hr_hat"]
    state = model.state_dict()
    params = dict(model.named_parameters())
    assert sorted(grads_j) == sorted(params)
    for name, p in params.items():
        assert p.grad is not None, name
        conv_bias = re.fullmatch(r"(en|de)coder\.\d+\.conv\.(\d+)\.bias", name)
        if conv_bias and int(conv_bias.group(2)) % 3 == 0:
            # conv biases of the ResBlocks: under stop-gradient, zero on both sides
            assert not p.grad.any() and not np.asarray(grads_j[name]).any(), name
            continue
        assert _rel_err(p.grad, grads_j[name]) <= tol["grad"], name
    flat = torch.cat([params[k].grad.flatten() for k in sorted(params)])
    flat_j = torch.cat([grads_j[k].flatten() for k in sorted(params)])
    if dtype_name == "f32":
        assert (flat - flat_j).norm() <= tol["grads"] * flat_j.norm()
    else:
        grads_j32 = jax_grads("f32")
        flat_j32 = torch.cat([grads_j32[k].flatten() for k in sorted(params)])
        assert (flat - flat_j).norm() <= tol["grads"] * (flat_j - flat_j32).norm()

    moved, moved_j, n_elem = 0, 0, 0
    for name, ref in after_j.items():
        got = state[name].numpy()
        if "running" in name:
            assert _rel_err(got, ref) <= tol["stat"], name
            continue
        ref = ref.numpy()
        assert np.abs(got - ref).max() <= tol["param"], name
        moved += int((np.abs(got - ref) > LR_RATE / 2).sum())
        n_elem += got.size
    assert moved <= tol["flips"] * n_elem
