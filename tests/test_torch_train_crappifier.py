"""The learned crappifier on the CPU (pssr2_tpu_torch/train.py:
``train_crappifier``, ``approximate_crappifier``; bayes.py), against the
JAX package:

- ``train_crappifier`` against JAX's on ``ResUNet(hidden=[8, 16], depth=1,
  scale=1)`` for one epoch, through the host pair loader, with a
  crappifier without randomness (defined alike for each package),
  ``rotation=False`` and Python's ``random`` seeded alike before each run,
  so both see the same batches in the same order: the losses and the
  weights after training, with and without ``clamp``;
- in the port alone: callbacks receive the loop's locals, ``.pth``
  checkpoints are written, ``collage_dir`` raises;
- ``gp_minimize`` (the port's copy of ``bayes.py``) and
  ``approximate_crappifier`` against JAX's on the same seeds.

Tolerances.  The step is the same function on both sides (soft
histogram, SSIM of the noise profiles, gradients clipped at 3, AdamW);
only the order of f32 sums differs, but the loss subtracts two soft
histograms of masses up to ~60 whose f32 sums round differently in torch
and XLA, and that cancellation leaves the gradients 1e-4 apart (relative
to a parameter's largest; measured 1.1e-4): one step's gradients are held
to 1e-3.  AdamW's first steps move every parameter by about the learning
rate (1e-3) with the sign of its gradient, so a parameter whose gradient
is near zero moves differently: after 3 steps the parameters are held to
5e-4 absolute (measured 1.8e-4), the running statistics to 1e-4 relative
(measured 2.8e-5), the losses to 1e-3 relative (measured 4.3e-4).  The
host objective is numpy on both sides: equal to float rounding (1e-12
relative).
"""

import random

import numpy as np
import pytest
import torch
from flax import nnx

from pssr2_tpu import Crappifier as JaxCrappifier
from pssr2_tpu.bayes import Integer as JaxInteger
from pssr2_tpu.bayes import Real as JaxReal
from pssr2_tpu.bayes import gp_minimize as jax_gp_minimize
from pssr2_tpu.checkpoint import _flatten_state
from pssr2_tpu.crappifiers import Poisson as JaxPoisson
from pssr2_tpu.data import ImageDataset as JaxImageDataset
from pssr2_tpu.data import tiff as jtiff
from pssr2_tpu.models import ResUNet as JaxResUNet
from pssr2_tpu.optim import AdamW as JaxAdamW
from pssr2_tpu.optim import ExponentialLR as JaxExponentialLR
from pssr2_tpu.train import approximate_crappifier as jax_approximate_crappifier
from pssr2_tpu.train import train_crappifier as jax_train_crappifier
from pssr2_tpu_torch import Crappifier, Poisson
from pssr2_tpu_torch.bayes import Integer, Real, gp_minimize
from pssr2_tpu_torch.checkpoint import load_weights
from pssr2_tpu_torch.data import ImageDataset
from pssr2_tpu_torch.models import ResUNet
from pssr2_tpu_torch.optim import AdamW, ExponentialLR
from pssr2_tpu_torch.train import approximate_crappifier, train_crappifier
from pssr2_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

HIDDEN, DEPTH = [8, 16], 1
TOL = {"grad": 1e-3, "loss": 1e-3, "param": 5e-4, "stat": 1e-4}
HOST_RTOL = 1e-12


class _Banding(Crappifier):
    """Deterministic stand-in for noise: a gain and a column pattern."""

    def crappify(self, image):
        return image * 0.9 + 6.0 * (np.arange(image.shape[-1]) % 3)


class _JaxBanding(JaxCrappifier):
    def crappify(self, image):
        return image * 0.9 + 6.0 * (np.arange(image.shape[-1]) % 3)


def _images(root, n=6, res=64, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:res, 0:res]
    root.mkdir(exist_ok=True)
    for i in range(n):
        img = 127 + 100 * np.sin(xx / (3 + i)) * np.cos(yy / (4 + i)) + rng.normal(0, 8, (res, res))
        jtiff.imwrite(root / f"im_{i}.tif", np.clip(img, 0, 255).astype(np.uint8))
    return root


def _pair(tmp_path):
    jmodel = JaxResUNet(hidden=HIDDEN, depth=DEPTH, scale=1, rngs=nnx.Rngs(0))
    model = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=1, device="cpu")
    model.load_state_dict(params_from_jax(_flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState)))), strict=True)
    return jmodel, model


KWARGS = dict(hr_res=64, lr_scale=4, rotation=False, val_split=0.3)


def test_one_step_gradients_match_jax(tmp_path):
    """The loss and the clipped gradients of one train step (learning rate
    0) against JAX's ``_crap_loss`` under ``nnx.value_and_grad``."""
    import jax.numpy as jnp

    from pssr2_tpu.ops.gradhist import make_gradhist as jax_make_gradhist
    from pssr2_tpu.util import SSIMLoss as JaxSSIMLoss
    from pssr2_tpu_torch.ops.gradhist import make_gradhist
    from pssr2_tpu_torch.train import _build_crappifier_steps
    from pssr2_tpu_torch.util import SSIMLoss

    root = _images(tmp_path / "imgs")
    jmodel, model = _pair(tmp_path)
    dataset = ImageDataset(root, crappifier=_Banding(), **KWARGS)
    hr = np.stack([dataset[i][0] for i in range(2)])
    lr = np.stack([dataset[i][1] for i in range(2)])
    ds_hr = hr[:, :, ::4, ::4]
    hist, ssim_loss = jax_make_gradhist(sigma=5), JaxSSIMLoss(ms=False)

    def jax_loss(m):
        pred, target = m(jnp.asarray(ds_hr)) - ds_hr, jnp.asarray(lr - ds_hr)
        return jnp.mean((hist(pred) - hist(target)) ** 2) / (lr.shape[-1] ** 2) * ssim_loss(pred, target)

    jmodel.train()
    loss_j, grads_j = nnx.value_and_grad(jax_loss)(jmodel)
    grads_j = params_from_jax({k: np.clip(np.asarray(v), -3, 3) for k, v in _flatten_state(grads_j).items()})

    step, _ = _build_crappifier_steps(make_gradhist(sigma=5), SSIMLoss(ms=False), False, 3)
    model.train()
    loss, _ = step(model, AdamW(0.0).init(model.parameters()), torch.from_numpy(hr), torch.from_numpy(lr), 0.0, 2, 4)
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * float(loss_j)
    for name, p in model.named_parameters():
        ref = grads_j[name]
        assert (p.grad - ref).abs().max() <= TOL["grad"] * max(ref.abs().max().item(), 1e-12), name


@pytest.mark.parametrize("clamp", [False, True], ids=["plain", "clamp"])
def test_train_crappifier_matches_jax(tmp_path, clamp):
    root = _images(tmp_path / "imgs")
    jmodel, model = _pair(tmp_path)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    random.seed(0)
    joptim = JaxAdamW(1e-3)
    train_j, val_j = jax_train_crappifier(
        jmodel, JaxImageDataset(root, crappifier=_JaxBanding(), **KWARGS), 2, joptim, 1,
        scheduler=JaxExponentialLR(joptim, 0.5), log_frequency=1, clamp=clamp, dataloader_kwargs={"num_workers": 1},
    )
    random.seed(0)
    optim = AdamW(1e-3)
    train_t, val_t = train_crappifier(
        model, ImageDataset(root, crappifier=_Banding(), **KWARGS), 2, optim, 1, device="cpu",
        scheduler=ExponentialLR(optim, 0.5), log_frequency=1, clamp=clamp, dataloader_kwargs={"num_workers": 1},
    )
    assert len(train_t) == len(train_j) == 3 and len(val_t) == len(val_j) == 1
    assert all(v > 0 for v in train_t)
    np.testing.assert_allclose(train_t, train_j, rtol=TOL["loss"])
    np.testing.assert_allclose(val_t, val_j, rtol=TOL["loss"])
    assert optim.lr == joptim.lr == 5e-4 and not model.training
    after = params_from_jax(_flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState))))
    state = model.state_dict()
    for name, ref in after.items():
        err = (state[name] - ref).abs().max().item()
        if "running" in name:
            assert err <= TOL["stat"] * ref.abs().max().item(), name
        else:
            assert err <= TOL["param"], name
    assert (state["reconstruction.conv.weight"] - init["reconstruction.conv.weight"]).abs().max() > 1e-4  # it trained


def test_train_crappifier_callbacks_checkpoints_and_collage(tmp_path):
    root = _images(tmp_path / "imgs")
    _, model = _pair(tmp_path)
    seen = []
    plain = []
    dataset = ImageDataset(root, crappifier=_Banding(), **KWARGS)
    train_crappifier(
        model, dataset, 2, AdamW(1e-3), 2, device="cpu", checkpoint_dir=str(tmp_path / "ckpt"),
        callbacks=[lambda local: seen.append((local["epoch"], local["batch_idx"], tuple(local["tensors"][1].shape))),
                   lambda: plain.append(1)],
        dataloader_kwargs={"num_workers": 1},
    )
    assert seen == [(e, b, (2 if b < 2 else 1, 1, 16, 16)) for e in range(2) for b in range(3)]
    assert len(plain) == 6
    ckpts = sorted((tmp_path / "ckpt").glob("*.pth"))
    assert len(ckpts) == 1 and ckpts[0].name.startswith("checkpoint0_ResUNet_")
    fresh = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=1, device="cpu")
    load_weights(fresh, str(ckpts[0]))
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        train_crappifier(model, dataset, 2, AdamW(1e-3), 1, device="cpu", collage_dir=str(tmp_path / "c"))


def test_gp_minimize_matches_jax():
    def objective(p):
        return (p[0] - 0.3) ** 2 + 0.1 * abs(p[1] - 4) + 0.01 * np.sin(7 * p[0])

    ours = gp_minimize(objective, [Real(-1, 1), Integer(0, 8)], n_calls=14, n_initial_points=5, random_state=3)
    theirs = jax_gp_minimize(objective, [JaxReal(-1, 1), JaxInteger(0, 8)], n_calls=14, n_initial_points=5,
                             random_state=3)
    assert ours.x == theirs.x and ours.x_iters == theirs.x_iters
    np.testing.assert_allclose(ours.func_vals, theirs.func_vals, rtol=HOST_RTOL)
    assert ours.fun == min(ours.func_vals)


def test_approximate_crappifier_matches_jax(tmp_path):
    root = _images(tmp_path / "imgs", n=4)
    kwargs = dict(hr_res=64, lr_scale=4, rotation=False, val_split=0.25)
    runs = []
    for approx, poisson, real, dataset_cls in ((approximate_crappifier, Poisson, Real, ImageDataset),
                                               (jax_approximate_crappifier, JaxPoisson, JaxReal, JaxImageDataset)):
        np.random.seed(0)
        random.seed(0)
        dataset = dataset_cls(root, crappifier=poisson(intensity=1.2), **kwargs)
        runs.append(approx(poisson, [real(0.5, 2)], dataset, max_images=2,
                           opt_kwargs={"n_calls": 6, "n_initial_points": 3, "random_state": 1}))
    ours, theirs = runs
    assert ours.x_iters == theirs.x_iters
    np.testing.assert_allclose(ours.func_vals, theirs.func_vals, rtol=HOST_RTOL)
    assert 0.5 <= ours.x[0] <= 2
