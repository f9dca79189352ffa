"""The port's training loop (pssr2_tpu_torch/train.py: ``train_paired``,
``_PairBatchLoader``, ``_use_device_pipeline``), its schedulers and SGD
(optim.py) and its checkpoints (checkpoint.py), on the CPU.

- Schedulers and SGD against ``pssr2_tpu/optim.py`` (and ``optax.sgd``).
- ``train_paired`` against JAX's ``train_paired`` on a deterministic
  configuration: ``ImageDataset(hr_res=192, crappifier=None,
  rotation=False)`` through the host pair loader, ``ResUNet(hidden=[8,
  16], depth=1)``, batch 2 (the last batch partial), ``SSIMLoss(mix=0.8,
  ms=True)``, AdamW with ``ExponentialLR``, 2 epochs, the same weights
  through ``params_from_jax`` and Python's ``random`` seeded alike before
  each run, so both draw the same training order.  Measured: losses within
  4.5e-7, weights within 1e-6, running statistics within 7.1e-7 relative;
  held to ``LOOP_TOL``.
- In the port alone, on the device pipeline (Poisson noise, random
  augmentation): ``steps_per_dispatch=2`` equals per-step training, a
  ``state_dir`` resume equals an uninterrupted run exactly, a SIGTERM
  saves the state, and weights round-trip through ``.pth`` and load from
  the JAX ``.npz``.
"""

import os
import random
import signal

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import nnx

from pssr2_tpu.checkpoint import _flatten_state
from pssr2_tpu.checkpoint import save_weights as jax_save_weights
from pssr2_tpu.data import tiff as jtiff
from pssr2_tpu.data.datasets import ImageDataset as JaxImageDataset
from pssr2_tpu.models import ResUNet as JaxResUNet
from pssr2_tpu.optim import AdamW as JaxAdamW
from pssr2_tpu.optim import ExponentialLR as JaxExponentialLR
from pssr2_tpu.optim import ReduceLROnPlateau as JaxReduceLROnPlateau
from pssr2_tpu.train import train_paired as jax_train_paired
from pssr2_tpu.util import SSIMLoss as JaxSSIMLoss
from pssr2_tpu_torch import Crappifier, Poisson
from pssr2_tpu_torch.checkpoint import load_weights, save_weights
from pssr2_tpu_torch.data import ImageDataset
from pssr2_tpu_torch.models import ResUNet
from pssr2_tpu_torch.optim import SGD, AdamW, ExponentialLR, ReduceLROnPlateau
from pssr2_tpu_torch.train import _use_device_pipeline, train_paired
from pssr2_tpu_torch.util import SSIMLoss
from pssr2_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

HIDDEN, DEPTH = [8, 16], 1
# train_paired against JAX: losses (abs), parameters after training (abs),
# running statistics (relative).  Only the order of f32 sums differs, over
# 6 AdamW steps.
LOOP_TOL = {"loss": 1e-5, "param": 1e-5, "stat": 1e-5}


def _images(root, n, res, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:res, 0:res]
    root.mkdir(exist_ok=True)
    for i in range(n):
        img = 127 + 100 * np.sin(xx / (3 + i)) * np.cos(yy / (4 + i)) + rng.normal(0, 8, (res, res))
        jtiff.imwrite(root / f"im_{i}.tif", np.clip(img, 0, 255).astype(np.uint8))
    return root


def _model(seed=0):
    model = ResUNet(hidden=HIDDEN, depth=DEPTH, device="cpu")
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.1)
    return model


# ---- schedulers and SGD -------------------------------------------------------


class _Lr:
    def __init__(self, lr):
        self.lr = lr


@pytest.mark.parametrize("kind", ["exponential", "plateau_min", "plateau_max"])
def test_schedulers_match_jax(kind):
    """The learning rate after each epoch's step, for the same metrics."""
    metrics = [1.0, 0.9, 0.8999, 0.95, 0.9, 0.91, 0.5, 0.6, 0.6, 0.7, 0.2, 0.3]
    ours, theirs = _Lr(1e-3), _Lr(1e-3)
    if kind == "exponential":
        a, b = ExponentialLR(ours, 0.7), JaxExponentialLR(theirs, 0.7)
    else:
        mode = kind.split("_")[1]
        kwargs = dict(mode=mode, factor=0.5, patience=1, threshold=1e-3, min_lr=2e-4)
        a, b = ReduceLROnPlateau(ours, **kwargs), JaxReduceLROnPlateau(theirs, **kwargs)
    seen = set()
    for m in metrics:
        if kind == "exponential":
            a.step(), b.step()
        else:
            a.step(m), b.step(m)
        assert ours.lr == theirs.lr
        seen.add(ours.lr)
    assert len(seen) > 2  # the rate moved, and for the plateau stopped at min_lr
    with pytest.raises(ValueError):
        ReduceLROnPlateau(ours, mode="median")


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_matches_optax(momentum):
    rng = np.random.default_rng(1)
    w0 = rng.normal(0, 1, (4, 3)).astype(np.float32)
    grads = [rng.normal(0, 1, (4, 3)).astype(np.float32) for _ in range(3)]
    tx = optax.sgd(1e-2, momentum=momentum if momentum else None)
    jw, state = jnp.asarray(w0), None
    state = tx.init(jw)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = SGD(1e-2, momentum=momentum).init([p])
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, updates)
        p.grad = torch.from_numpy(g.copy())
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


# ---- train_paired against JAX -------------------------------------------------


def test_train_paired_matches_jax(tmp_path):
    root = _images(tmp_path / "imgs", 6, 192)
    kwargs = dict(hr_res=192, lr_scale=4, crappifier=None, rotation=False, val_split=0.3)
    jmodel = JaxResUNet(hidden=HIDDEN, depth=DEPTH)
    model = ResUNet(hidden=HIDDEN, depth=DEPTH, device="cpu")
    model.load_state_dict(params_from_jax(_flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState)))), strict=True)
    dataset = ImageDataset(root, **kwargs)
    assert _use_device_pipeline(dataset) is False
    assert len(dataset) - len(dataset.val_idx) == 5  # 3 batches a epoch, the last partial

    random.seed(0)
    joptim = JaxAdamW(1e-3)
    train_j, val_j = jax_train_paired(
        jmodel, JaxImageDataset(root, **kwargs), 2, JaxSSIMLoss(mix=0.8, ms=True), joptim, 2,
        scheduler=JaxExponentialLR(joptim, 0.5), log_frequency=1, dataloader_kwargs={"num_workers": 1},
    )
    random.seed(0)
    optim = AdamW(1e-3)
    train_t, val_t = train_paired(
        model, dataset, 2, SSIMLoss(mix=0.8, ms=True), optim, 2, device="cpu",
        scheduler=ExponentialLR(optim, 0.5), log_frequency=1, dataloader_kwargs={"num_workers": 1},
    )
    assert len(train_t) == len(train_j) == 6 and len(val_t) == len(val_j) == 2
    np.testing.assert_allclose(train_t, train_j, rtol=0, atol=LOOP_TOL["loss"])
    np.testing.assert_allclose(val_t, val_j, rtol=0, atol=LOOP_TOL["loss"])
    assert optim.lr == joptim.lr == 2.5e-4
    assert not model.training
    after = params_from_jax(_flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState))))
    state = model.state_dict()
    for name, ref in after.items():
        err = (state[name] - ref).abs().max().item()
        if "running" in name:
            assert err <= LOOP_TOL["stat"] * ref.abs().max().item(), name
        else:
            assert err <= LOOP_TOL["param"], name


# ---- the port alone ------------------------------------------------------------


def _device_pipe_run(root, epochs, tmp, steps_per_dispatch=1, state_dir=None, checkpoint_dir=None,
                     callbacks=None, scheduler=None, optim=None, model=None):
    dataset = ImageDataset(root, hr_res=64, lr_scale=4, crappifier=Poisson(), val_split=0.2)
    assert _use_device_pipeline(dataset) == "fused"
    model = _model() if model is None else model
    optim = AdamW(1e-3) if optim is None else optim
    losses = train_paired(
        model, dataset, 2, SSIMLoss(mix=0.8, ms=False), optim, epochs, device="cpu",
        scheduler=scheduler(optim) if scheduler else None, log_frequency=100, seed=3,
        steps_per_dispatch=steps_per_dispatch, state_dir=state_dir, checkpoint_dir=checkpoint_dir,
        callbacks=callbacks, dataloader_kwargs={"num_workers": 2},
    )
    return model, optim, losses


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)


def test_steps_per_dispatch_equals_per_step(tmp_path):
    """12 training images, batch 2: per-step, and 2 steps per call (batches
    1-2 buffered, the rest per step); the same losses, weights and learning
    rate, and each batch's callback fires once.  A ReduceLROnPlateau that
    never sees an improvement cuts the rate after the second epoch."""
    root = _images(tmp_path / "imgs", 15, 64, seed=1)
    runs = []
    for k in (1, 2):
        calls = []
        random.seed(1)
        model, optim, losses = _device_pipe_run(
            root, 2, tmp_path, steps_per_dispatch=k, callbacks=[lambda: calls.append(1)],
            scheduler=lambda o: ReduceLROnPlateau(o, factor=0.1, patience=0, threshold=10.0),
        )
        runs.append((model, optim, losses))
        assert len(calls) == 2 * 6
        assert optim.lr == pytest.approx(1e-4)
        assert all(np.isfinite(v) for part in losses for v in part)
    (m1, _, l1), (m2, _, l2) = runs
    assert l1 == l2
    assert _same_state(m1, m2)


def test_state_dir_resume_equals_uninterrupted_run(tmp_path):
    """3 epochs at once, against 2 epochs, then a second call with
    epochs=3 that resumes from the state saved after epoch 2 and runs one
    epoch: the same last-epoch losses and the same weights, bit for bit
    (each step's device degradation draws from a generator seeded by
    (seed, epoch, step), and Python's random, which orders the training
    samples as in the JAX package, is seeded once before both runs).  The
    state directory keeps the newest two epochs; the weight checkpoints are
    named as the JAX package names them, with ``.pth``."""
    root = _images(tmp_path / "imgs", 10, 64, seed=2)
    random.seed(7)
    full, _, (train_full, val_full) = _device_pipe_run(root, 3, tmp_path)

    random.seed(7)
    state_dir, ckpt = tmp_path / "state", tmp_path / "ckpt"
    _, _, (_, val_first) = _device_pipe_run(root, 2, tmp_path, state_dir=state_dir, checkpoint_dir=ckpt)
    assert sorted(os.listdir(state_dir)) == ["epoch_1.pt", "epoch_2.pt"]
    assert val_first == val_full[:2]
    names = sorted(os.listdir(ckpt))
    assert len(names) == 1 and names[0].startswith("checkpoint0_ResUNet_") and names[0].endswith(".pth")

    resumed, _, (train_res, val_res) = _device_pipe_run(root, 3, tmp_path, state_dir=state_dir)
    assert sorted(os.listdir(state_dir)) == ["epoch_2.pt", "epoch_3.pt"]
    assert val_res == val_full[2:] and train_res == train_full[-len(train_res):]
    assert _same_state(resumed, full)


def test_sigterm_saves_state_and_exits(tmp_path):
    """A SIGTERM during a step saves the state at the current epoch and
    ends the run; the previous SIGTERM handler is back afterwards."""
    root = _images(tmp_path / "imgs", 6, 64, seed=3)
    before = signal.getsignal(signal.SIGTERM)

    def term(local):
        if local["batch_idx"] == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    with pytest.raises(SystemExit) as exc:
        _device_pipe_run(root, 2, tmp_path, state_dir=tmp_path / "state", callbacks=[term])
    assert exc.value.code == 0
    assert os.listdir(tmp_path / "state") == ["epoch_0.pt"]
    assert signal.getsignal(signal.SIGTERM) == before


def test_callbacks_receive_the_loop_locals(tmp_path):
    root = _images(tmp_path / "imgs", 6, 64, seed=4)
    seen = []

    def cb(local):
        seen.append((local["epoch"], local["batch_idx"], tuple(local["hr_hat"].shape), local["n_valid"]))

    _device_pipe_run(root, 1, tmp_path, callbacks=[cb], steps_per_dispatch=4)  # locals force per-step
    assert seen == [(0, 0, (2, 1, 64, 64), 2), (0, 1, (2, 1, 64, 64), 2), (0, 2, (1, 1, 64, 64), 1)]


def test_weights_round_trip_and_load_jax_npz(tmp_path):
    model = _model(5)
    save_weights(model, tmp_path / "w.pth")
    other = load_weights(_model(6), tmp_path / "w.pth")
    assert _same_state(model, other)

    jmodel = JaxResUNet(hidden=HIDDEN, depth=DEPTH)
    jax_save_weights(jmodel, tmp_path / "w.npz")
    loaded = load_weights(_model(7), str(tmp_path / "w.npz"))
    ref = params_from_jax(_flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState))))
    assert all(torch.equal(loaded.state_dict()[k], v) for k, v in ref.items())


class _HostOnly(Crappifier):
    def crappify(self, image):
        return image


@pytest.mark.parametrize("option", ["mesh", "tp_rules", "dp_shard_map", "collage_dir", "host_crappifier"])
def test_unported_options_raise(tmp_path, option):
    root = _images(tmp_path / "imgs", 3, 64)
    crappifier = _HostOnly() if option == "host_crappifier" else Poisson()
    dataset = ImageDataset(root, hr_res=64, lr_scale=4, crappifier=crappifier, val_split=0.5)
    kwargs = {"host_crappifier": {}, "collage_dir": {"collage_dir": str(tmp_path / "c")},
              "dp_shard_map": {"dp_shard_map": True}}.get(option, {option: object()})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train_paired(_model(), dataset, 2, SSIMLoss(ms=False), AdamW(), 1, device="cpu", **kwargs)
