"""Training (counterpart: pssr2_tpu/train.py:45-128, 247-970; reference:
pssr/train.py).

One step: (optionally) the device degradation of a uint8 HR batch into an
(hr, lr) pair, the forward, the loss on the [0, 1] scale, the backward and
one optimizer step.  The JAX package jits the step; PyTorch runs it
eagerly, with the hand-written kernels under the model and the loss.
``train_paired`` keeps the reference's control surface around it: loss
every ``log_frequency`` steps, per-epoch validation in a seeded order,
schedulers, weight checkpoints, per-batch callbacks, and full-state resume.
``train_crappifier`` trains a scale-1 model as a learned crappifier with
the soft-histogram loss (``ops/gradhist.py``); ``approximate_crappifier``
fits a crappifier's parameters on the host by Bayesian optimization
(``bayes.py``).

Not ported yet: the multi-device paths (``mesh``, ``tp_rules``,
``dp_shard_map``), the validation collage and the host-crappifier
fallback.
"""

import os
import random
import signal

import numpy as np
import torch

from . import resolve_device
from .checkpoint import load_full_state, save_full_state, save_weights
from .data.indexing import RandomIterIdx, invert_idx
from .data.pipeline import PatchLoader, make_device_gen_pair
from .ops.degrade import to_device_fn
from .ops.gradhist import make_gradhist
from .ops.ssim import ssim
from .optim import ReduceLROnPlateau
from .util import SSIMLoss, _get_callbacks, _psnr_metric, pixel_metric

IMAGE_RANGE = 255


def _set_lr(optimizer, lr_rate):
    """Write the scheduler-controlled learning rate into the optimizer."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr_rate)


def _loss_scaled(loss_fn, hr_hat, hr):
    """``loss_fn(hr_hat / IMAGE_RANGE, hr / IMAGE_RANGE)``, through the
    loss's ``scaled`` hook where it has one (util.SSIMLoss)."""
    fn = getattr(loss_fn, "scaled", None)
    if fn is not None:
        return fn(hr_hat, hr, IMAGE_RANGE)
    return loss_fn(hr_hat / IMAGE_RANGE, hr / IMAGE_RANGE)


def _model_loss(model, loss_fn, clamp, lr, hr, extra):
    hr_hat = model(lr)
    if clamp:
        hr_hat = torch.clamp(hr_hat, 0, IMAGE_RANGE)
    if extra is None:
        loss = _loss_scaled(loss_fn, hr_hat, hr)
    else:
        loss = loss_fn(hr_hat / IMAGE_RANGE, hr / IMAGE_RANGE, extra / IMAGE_RANGE)
    return loss, hr_hat


def _apply_grads(model, optimizer, loss, clip=None):
    """Backward and one optimizer step.  A parameter that autograd leaves
    without a gradient (the ResBlock conv biases under train-mode
    BatchNorm, detached) gets zeros, so AdamW decays it as optax does.
    ``clip``: clip every gradient element to [-clip, clip] first."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        elif clip is not None and clip > 0:
            p.grad.clamp_(-clip, clip)
    optimizer.step()


def _build_paired_steps(loss_fn, clamp, gen_pair):
    """Train and val steps.  ``gen_pair(generator, batch, augment)`` is the
    device degradation (None: batches arrive as ready (hr, lr) pairs).

    ``train_step(model, optimizer, batch, extra, generator, lr_rate,
    n_valid, with_metrics)`` -> (loss, metrics, (lr, hr_hat, hr)), with
    ``metrics`` None or (mse, ssim) of the step's output;
    ``val_step(model, batch, extra, generator, n_valid)`` -> (loss,
    (lr, hr_hat, hr)).  Returned tensors are detached.
    """

    def _prepare(batch, generator, n_valid, train):
        if gen_pair is not None:
            hr, lr = gen_pair(generator, batch, augment=train)
        else:
            hr, lr = batch
        return hr[:n_valid], lr[:n_valid]

    def train_step(model, optimizer, batch, extra, generator, lr_rate, n_valid, with_metrics):
        with torch.no_grad():
            hr, lr = _prepare(batch, generator, n_valid, train=True)
        if extra is not None:
            extra = extra[:n_valid]
        _set_lr(optimizer, lr_rate)
        loss, hr_hat = _model_loss(model, loss_fn, clamp, lr, hr, extra)
        _apply_grads(model, optimizer, loss)
        hr_hat = hr_hat.detach()

        metrics = None
        if with_metrics:
            with torch.no_grad():
                mse = torch.mean((hr_hat / IMAGE_RANGE - hr / IMAGE_RANGE) ** 2)
                metrics = (mse, ssim(hr_hat, hr, data_range=IMAGE_RANGE))
        return loss.detach(), metrics, (lr, hr_hat, hr)

    def val_step(model, batch, extra, generator, n_valid):
        with torch.no_grad():
            hr, lr = _prepare(batch, generator, n_valid, train=False)
            if extra is not None:
                extra = extra[:n_valid]
            loss, hr_hat = _model_loss(model, loss_fn, clamp, lr, hr, extra)
        return loss, (lr, hr_hat, hr)

    return train_step, val_step


def _build_multi_train_step(loss_fn, clamp, gen_pair):
    """K train steps per call, each with its own generator
    (``train_paired(steps_per_dispatch=K)``): a plain loop of full-batch
    steps.  ``multi_train_step(model, optimizer, batches, extras,
    generators, lr_rate)`` -> (K,) losses."""

    def multi_train_step(model, optimizer, batches, extras, generators, lr_rate):
        _set_lr(optimizer, lr_rate)
        losses = []
        for k, generator in enumerate(generators):
            extra = None if extras is None else extras[k]
            with torch.no_grad():
                if gen_pair is not None:
                    hr, lr = gen_pair(generator, batches[k], augment=True)
                else:
                    hr, lr = batches[0][k], batches[1][k]
            loss, _ = _model_loss(model, loss_fn, clamp, lr, hr, extra)
            _apply_grads(model, optimizer, loss)
            losses.append(loss.detach())
        return torch.stack(losses)

    return multi_train_step


def _use_device_pipeline(dataset):
    """The on-device degradation applies when the dataset generates LR by
    crappification.  Returns ``"fused"`` when the crappifier has a device
    form, ``"callback"`` when it has none (the JAX package then runs it on
    the host through a callback), or False (host pair loader)."""
    ok = (
        not dataset.is_lr
        and getattr(dataset, "crappifier", None) is not None
        and getattr(dataset, "extra_hr_files", None) is None
        and getattr(dataset, "transforms", None) is None
        and type(dataset).__name__ in ("ImageDataset", "SlidingDataset")
    )
    if not ok:
        return False
    return "fused" if to_device_fn(dataset.crappifier) is not None else "callback"


class _PairBatchLoader:
    """Host loader: items come from ``dataset[idx]`` (the reference's pair
    path); yields ((hr, lr), extra_or_None, n_valid) as numpy, padded to
    ``batch_size`` by repeating the batch's last item."""

    def __init__(self, dataset, sampler, batch_size, num_workers=4):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self):
        return (len(self.sampler) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        order = list(self.sampler)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                idx = order[start : start + self.batch_size]
                n_valid = len(idx)
                rows = [idx[min(r, n_valid - 1)] for r in range(self.batch_size)]
                items = list(pool.map(self.dataset.__getitem__, rows))
                if getattr(self.dataset, "extra_hr_files", None) is not None:
                    pairs = [item[0] for item in items]
                    extra = np.stack([np.asarray(item[1]) for item in items])
                else:
                    pairs, extra = items, None
                hr = np.stack([np.asarray(p[0]) for p in pairs])
                lr = np.stack([np.asarray(p[1]) for p in pairs])
                yield (hr, lr), extra, n_valid


def _step_generator(device, seed, epoch, phase, batch_idx):
    """The random stream of one step's device degradation: a generator of
    its own, seeded from (seed, epoch, phase, batch), so that a resumed run
    draws what an uninterrupted one draws (the JAX package splits one key
    per step instead)."""
    state = np.random.SeedSequence([seed, epoch, phase, batch_idx]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _to_device(a, device):
    return None if a is None else torch.as_tensor(a).to(device, non_blocking=True)


def train_paired(
    model,
    dataset,
    batch_size: int,
    loss_fn,
    optim,
    epochs: int,
    device: str = None,
    scheduler=None,
    log_frequency: int = 50,
    checkpoint_dir: str = None,
    collage_dir: str = None,
    clamp: bool = False,
    dataloader_kwargs=None,
    callbacks=None,
    mesh=None,
    seed: int = 0,
    state_dir: str = None,
    tp_rules=None,
    steps_per_dispatch: int = 1,
    dp_shard_map: bool = False,
):
    """Trains model on paired high-low-resolution crappified data
    (reference: pssr/train.py:19-166; same control surface).

    Args:
        model : Any model of the port (``models.ResUNet``, ``models.RDResUNet``,
            ``models.SwinIR``; a ``torch.nn.Module``) to train; moved to
            ``device``.

        dataset : Paired image dataset to load data from.

        batch_size (int) : Batch size.

        loss_fn : Loss callable on [0,1] images (e.g. :class:`SSIMLoss`).

        optim : :class:`pssr2_tpu_torch.optim.AdamW` (or ``SGD``).  The
            optimizer state is created fresh per call; use ``state_dir``
            to carry it across restarts.

        epochs (int) : Number of epochs.

        device (str) : Device to train on; None means the CUDA card
            (``resolve_device``), ``"cpu"`` the CPU.

        scheduler : Optional scheduler from :mod:`pssr2_tpu_torch.optim`.

        log_frequency (int) : Steps between loss logging / metric refresh.

        checkpoint_dir (str) : Per-epoch weights checkpoint dir (``.pth``;
            None skips).

        collage_dir (str) : Per-epoch validation collage dir; not ported
            yet, and must be None.

        clamp (bool) : Clamp model output to image range before loss.

        dataloader_kwargs (dict) : ``num_workers`` for the host loader.

        callbacks (list[Callable]) : Per-batch callbacks; 1-arg callables
            receive the loop ``locals()`` (reference protocol,
            pssr/util.py:228-231).

        mesh, tp_rules, dp_shard_map : Multi-device training; not ported
            yet, and must be None / False.

        seed (int) : RNG seed for on-device augmentation/crappification.

        steps_per_dispatch (int) : Full-batch steps buffered and run by one
            call of the multi-step function (default 1 = per-step).  Metric
            and partial batches still run per step; callbacks that receive
            ``locals()`` force the per-step path; the callbacks of buffered
            steps fire after the call that ran them.

        state_dir (str) : Fault-tolerance directory.  When set, the full
            train state (model + optimizer + epoch) is saved each epoch,
            training resumes from the newest epoch on restart, and a SIGTERM
            saves the state before exit.

    Returns:
        train_losses (list[float]), val_losses (list[float])
    """
    if mesh is not None or tp_rules is not None or dp_shard_map:
        raise NotImplementedError(
            "train_paired: multi-device training (mesh, tp_rules, dp_shard_map) is not ported yet "
            "(ROADMAP queue 1 item 8); train on one device."
        )
    if collage_dir is not None:
        raise NotImplementedError(
            "train_paired: the validation collage (collage_dir) is not ported yet (ROADMAP queue 1 item 3)."
        )
    device = resolve_device(device)
    dataloader_kwargs = dataloader_kwargs or {}
    num_workers = dataloader_kwargs.get("num_workers", 4)
    callbacks, callback_locals = _get_callbacks(callbacks)
    image_range = IMAGE_RANGE

    use_device_pipe = _use_device_pipeline(dataset)
    if use_device_pipe == "callback":
        raise NotImplementedError(
            f"Crappifier {type(dataset.crappifier).__name__} has no device form in the port yet, and the "
            "host-crappifier fallback is not ported yet (ROADMAP queue 1 item 2)."
        )
    gen_pair = None
    if use_device_pipe:
        aug = make_device_gen_pair(dataset.lr_scale, dataset.crappifier, dataset.n_frames, augment=dataset.rotation)
        no_aug = make_device_gen_pair(dataset.lr_scale, dataset.crappifier, dataset.n_frames, augment=False)

        def gen_pair(generator, batch, augment):
            return (aug if augment else no_aug)(generator, batch)

    train_idx = list(invert_idx(dataset.val_idx, len(dataset)))
    train_sampler = RandomIterIdx(train_idx)
    val_sampler = RandomIterIdx(dataset.val_idx, seed=True)

    loader_cls = PatchLoader if use_device_pipe else _PairBatchLoader
    train_loader = loader_cls(dataset, train_sampler, batch_size, num_workers)
    val_loader = loader_cls(dataset, val_sampler, batch_size, num_workers)

    include_metric = isinstance(scheduler, ReduceLROnPlateau)

    model.to(device)
    optimizer = optim.init(model.parameters())
    train_step, val_step = _build_paired_steps(loss_fn, clamp, gen_pair)

    # steps_per_dispatch > 1: buffer K full batches for one multi-step call.
    # Locals-callbacks need per-batch tensors, so they force per-step.
    use_multi = steps_per_dispatch > 1 and not any(callback_locals)
    multi_train_step = _build_multi_train_step(loss_fn, clamp, gen_pair) if use_multi else None

    def generator(epoch, phase, batch_idx):
        return _step_generator(device, seed, epoch, phase, batch_idx) if gen_pair is not None else None

    # Fault tolerance: epoch-level resumable state + graceful SIGTERM save
    start_epoch = 0
    term_flag = {"set": False}
    old_handler = None
    if state_dir:
        start_epoch = load_full_state(state_dir, model, optimizer)
        if start_epoch:
            print(f"Resuming training from epoch {start_epoch} ({state_dir}).")

        def _on_term(signum, frame):
            term_flag["set"] = True

        try:
            old_handler = signal.signal(signal.SIGTERM, _on_term)
        except ValueError:
            pass  # not the main thread (e.g. GUI worker)

    def _wrap_batches(loader):
        if use_device_pipe:
            for batch, n_valid in loader:
                yield _to_device(batch, device), None, n_valid
        else:
            for (hr, lr), extra, n_valid in loader:
                yield (_to_device(hr, device), _to_device(lr, device)), _to_device(extra, device), n_valid

    train_losses, val_losses = [], []
    try:
        for epoch in range(start_epoch, epochs):
            model.train()
            print(f"Epoch {epoch}:")
            n_batches = len(train_loader)

            pending = []  # buffered full batches for the multi-step call

            def _flush_pending():
                if not pending:
                    return
                n_flushed = len(pending)
                if n_flushed < steps_per_dispatch:
                    # partial flushes step one by one
                    for b, e, g in pending:
                        train_step(model, optimizer, b, e, g, optim.lr, batch_size, False)
                else:
                    if gen_pair is not None:
                        batches = [p[0] for p in pending]
                    else:
                        batches = ([p[0][0] for p in pending], [p[0][1] for p in pending])
                    extras = None if pending[0][1] is None else [p[1] for p in pending]
                    multi_train_step(model, optimizer, batches, extras, [p[2] for p in pending], optim.lr)
                pending.clear()
                # buffered batches' callbacks fire here, after their steps ran,
                # so a callback sees state that includes its batch's update
                for _ in range(n_flushed):
                    for callback in callbacks:
                        callback()

            for batch_idx, (batch, extra, n_valid) in enumerate(_wrap_batches(train_loader)):
                step_gen = generator(epoch, 0, batch_idx)
                with_metrics = batch_idx % log_frequency == 0 or batch_idx == n_batches - 1
                if (
                    use_multi
                    and not with_metrics
                    and n_valid == batch_size
                    and batch_idx < n_batches - 2
                    and not term_flag["set"]
                ):
                    pending.append((batch, extra, step_gen))
                    if len(pending) == steps_per_dispatch:
                        _flush_pending()
                    continue
                _flush_pending()
                loss, metrics, tensors = train_step(
                    model, optimizer, batch, extra, step_gen, optim.lr, n_valid, with_metrics
                )
                # exposed in locals() for monitoring callbacks
                lr, hr_hat, hr = tensors

                if with_metrics:
                    train_losses.append(float(loss))
                    mse, s = metrics
                    mse = float(mse)
                    print(
                        f"  batch {batch_idx + 1}/{n_batches}: loss[{train_losses[-1]:.4f}], "
                        f"pixel[{pixel_metric(mse, image_range):.2f}], "
                        f"psnr[{float(_psnr_metric(mse)):.2f}], ssim[{float(s):.3f}]"
                    )

                for idx, callback in enumerate(callbacks):
                    if callback_locals[idx]:
                        callback(locals())
                    else:
                        callback()

                if term_flag["set"]:
                    save_full_state(state_dir, model, optimizer, epoch)
                    print(f"SIGTERM: saved train state at epoch {epoch} to {state_dir}; exiting.")
                    raise SystemExit(0)

            _flush_pending()

            # Validation (seeded sampler order; reference: pssr/train.py:121-148)
            model.eval()
            print(f"Epoch {epoch} validation...")
            val_loss = []
            for batch_idx, (batch, extra, n_valid) in enumerate(_wrap_batches(val_loader)):
                loss, _ = val_step(model, batch, extra, generator(epoch, 1, batch_idx), n_valid)
                val_loss.append(float(loss))

            val_loss = sum(val_loss) / len(val_loss)
            val_losses.append(val_loss)
            print(f"Epoch {epoch} validation loss: {val_loss:4f}\n")

            if state_dir:
                save_full_state(state_dir, model, optimizer, epoch + 1)

            if checkpoint_dir and epoch < epochs - 1:
                os.makedirs(checkpoint_dir, exist_ok=True)
                save_weights(model, f"{checkpoint_dir}/checkpoint{epoch}_{type(model).__name__}_{val_loss:.4f}.pth")

            if scheduler:
                if include_metric:
                    scheduler.step(val_loss)
                else:
                    scheduler.step()
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)

    model.eval()
    return train_losses, val_losses


def _build_crappifier_steps(hist_fn, ssim_loss, clamp, clip):
    """Train and val steps of :func:`train_crappifier`: the model maps the
    HR subsampled to the LR grid (``ds_hr = hr[..., ::scale, ::scale]``) to
    a predicted LR; the loss is the mean squared difference of the soft
    noise histograms of ``lr_hat - ds_hr`` and ``lr - ds_hr`` over the LR
    area, times the SSIM loss of those two noise profiles
    (pssr2_tpu/train.py:808-814; reference: pssr/train.py:388-402).
    Returned tensors are detached."""

    def crap_loss(lr, lr_hat, ds_hr):
        pred_profile = lr_hat - ds_hr
        target_profile = lr - ds_hr
        dist_error = torch.mean((hist_fn(pred_profile) - hist_fn(target_profile)) ** 2) / (lr.shape[-1] ** 2)
        return dist_error * ssim_loss(pred_profile, target_profile)

    def forward(model, hr, lr, n_valid, scale):
        hr, lr = hr[:n_valid], lr[:n_valid]
        ds_hr = hr[:, :, ::scale, ::scale]
        lr_hat = model(ds_hr)
        if clamp:
            lr_hat = torch.clamp(lr_hat, 0, IMAGE_RANGE)
        return crap_loss(lr, lr_hat, ds_hr), (lr, lr_hat, hr)

    def train_step(model, optimizer, hr, lr, lr_rate, n_valid, scale):
        _set_lr(optimizer, lr_rate)
        loss, (lr, lr_hat, hr) = forward(model, hr, lr, n_valid, scale)
        _apply_grads(model, optimizer, loss, clip)
        return loss.detach(), (lr, lr_hat.detach(), hr)

    def val_step(model, hr, lr, n_valid, scale):
        with torch.no_grad():
            return forward(model, hr, lr, n_valid, scale)

    return train_step, val_step


def train_crappifier(
    model,
    dataset,
    batch_size: int,
    optim,
    epochs: int,
    sigma: int = 5,
    clip: float = 3,
    device: str = None,
    scheduler=None,
    log_frequency: int = 50,
    checkpoint_dir: str = None,
    collage_dir: str = None,
    clamp: bool = False,
    dataloader_kwargs=None,
    callbacks=None,
    seed: int = 0,
):
    """EXPERIMENTAL: trains a model as a learned crappifier on paired data;
    loss = MSE of differentiable noise histograms x SSIM of the noise
    profiles (reference: pssr/train.py:168-322, 388-402).  The model must
    preserve input size (``scale=1``).

    Args:
        model : A model of the port with ``scale=1`` (``models.ResUNet``,
            a ``torch.nn.Module``); moved to ``device``.

        dataset : Paired image dataset; its (hr, lr) items come from the
            host pair loader, crappified on the host.

        batch_size (int) : Batch size.

        optim : :class:`pssr2_tpu_torch.optim.AdamW` (or ``SGD``).

        epochs (int) : Number of epochs.

        sigma (int) : Sharpness of the soft histogram's bins. Default 5.

        clip (float) : Clip every gradient element to [-clip, clip]
            (None or 0: no clipping). Default 3.

        device (str) : None means the CUDA card, ``"cpu"`` the CPU.

        scheduler : Optional scheduler from :mod:`pssr2_tpu_torch.optim`.

        log_frequency (int) : Steps between loss logging.

        checkpoint_dir (str) : Per-epoch weights checkpoint dir (``.pth``).

        collage_dir (str) : Per-epoch validation collage dir; not ported
            yet, and must be None.

        clamp (bool) : Clamp the model output to image range before the loss.

        dataloader_kwargs (dict) : ``num_workers`` for the host loader.

        callbacks (list[Callable]) : Per-batch callbacks; 1-arg callables
            receive the loop ``locals()``.

        seed (int) : Unused (the host loader draws from numpy's and Python's
            global streams, as in the JAX package); kept for its signature.

    Returns:
        train_losses (list[float]), val_losses (list[float])
    """
    if collage_dir is not None:
        raise NotImplementedError(
            "train_crappifier: the validation collage (collage_dir) is not ported yet (ROADMAP queue 1 item 3)."
        )
    device = resolve_device(device)
    dataloader_kwargs = dataloader_kwargs or {}
    num_workers = dataloader_kwargs.get("num_workers", 4)
    callbacks, callback_locals = _get_callbacks(callbacks)

    train_sampler = RandomIterIdx(list(invert_idx(dataset.val_idx, len(dataset))))
    val_sampler = RandomIterIdx(dataset.val_idx, seed=True)
    train_loader = _PairBatchLoader(dataset, train_sampler, batch_size, num_workers)
    val_loader = _PairBatchLoader(dataset, val_sampler, batch_size, num_workers)
    include_metric = isinstance(scheduler, ReduceLROnPlateau)

    model.to(device)
    optimizer = optim.init(model.parameters())
    train_step, val_step = _build_crappifier_steps(make_gradhist(sigma=sigma), SSIMLoss(ms=False), clamp, clip)

    def batches(loader):
        for (hr, lr), _extra, n_valid in loader:
            yield _to_device(hr, device), _to_device(lr, device), n_valid

    train_losses, val_losses = [], []
    for epoch in range(epochs):
        model.train()
        print(f"Epoch {epoch}:")
        n_batches = len(train_loader)
        for batch_idx, (hr, lr, n_valid) in enumerate(batches(train_loader)):
            scale = int(hr.shape[-1] / lr.shape[-1])
            loss, tensors = train_step(model, optimizer, hr, lr, optim.lr, n_valid, scale)
            if batch_idx % log_frequency == 0 or batch_idx == n_batches - 1:
                train_losses.append(float(loss))
                print(f"  batch {batch_idx + 1}/{n_batches}: loss[{train_losses[-1]:.4f}]")
            for idx, callback in enumerate(callbacks):
                if callback_locals[idx]:
                    callback(locals())
                else:
                    callback()

        model.eval()
        print(f"Epoch {epoch} validation...")
        val_loss = []
        for hr, lr, n_valid in batches(val_loader):
            scale = int(hr.shape[-1] / lr.shape[-1])
            loss, _ = val_step(model, hr, lr, n_valid, scale)
            val_loss.append(float(loss))

        val_loss = sum(val_loss) / len(val_loss)
        val_losses.append(val_loss)
        print(f"Epoch {epoch} validation loss: {val_loss:4f}\n")

        if checkpoint_dir and epoch < epochs - 1:
            os.makedirs(checkpoint_dir, exist_ok=True)
            save_weights(model, f"{checkpoint_dir}/checkpoint{epoch}_{type(model).__name__}_{val_loss:.4f}.pth")
        if scheduler:
            if include_metric:
                scheduler.step(val_loss)
            else:
                scheduler.step()

    model.eval()
    return train_losses, val_losses


def approximate_crappifier(crappifier, space, dataset, max_images=None, opt_kwargs=None):
    """Approximates :class:`Crappifier` parameters from real paired images by
    Bayesian optimization (reference: pssr/train.py:324-386; the crappifier
    objective is non-differentiable so gp minimization is used).  Host
    numpy throughout.

    Args:
        crappifier : Crappifier *class* whose parameter space is optimized.

        space : List of parameter spaces (:class:`pssr2_tpu_torch.bayes.Real` /
            ``Integer``), one per crappifier parameter.

        dataset : Paired image dataset.

        max_images (int) : Samples averaged per optimization step.

        opt_kwargs (dict) : Keyword arguments for ``gp_minimize``.
    """
    from .bayes import gp_minimize

    space = [space] if not isinstance(space, list) else space
    n_samples = len(dataset) if max_images is None else min(max_images, len(dataset))
    opt_kwargs = {} if opt_kwargs is None else opt_kwargs

    objective = _CrappifierObjective(crappifier, dataset, n_samples).sample
    return gp_minimize(objective, space, **opt_kwargs)


class _CrappifierObjective:
    """(reference: pssr/train.py:348-386; pssr2_tpu/train.py:924-970)"""

    def __init__(self, crappifier, dataset, n_samples):
        self.crappifier = crappifier
        self.dataset = dataset
        self.n_samples = n_samples

    def sample(self, params):
        from .ops.resize import resize_bilinear_np

        sample_idx = list(range(len(self.dataset)))
        random.shuffle(sample_idx)

        metrics = []
        for idx in sample_idx[: self.n_samples]:
            hr, lr = self.dataset[idx]
            hr = np.clip(np.asarray(hr), 0, 255).astype(np.uint8)
            lr = np.clip(np.asarray(lr), 0, 255).astype(np.uint8)

            # the HR downsampled to the LR grid is the baseline of both noise profiles
            ds_hr = np.clip(np.round(resize_bilinear_np(hr, *lr.shape[-2:])), 0, 255).astype(np.uint8)
            # the candidate is quantized as the acquisition quantizes the real LR
            # (round + uint8 clip), as in the JAX package (a deliberate deviation
            # from the reference, whose continuous candidate biases the fit)
            lr_hat = np.clip(np.round(self.crappifier(*params).crappify(ds_hr)), 0, 255)

            pred_profile = lr_hat.astype(np.float32) - ds_hr.astype(np.float32)
            target_profile = lr.astype(np.float32) - ds_hr.astype(np.float32)

            bins = np.arange(-256, 256)
            pred_dist, _ = np.histogram(pred_profile.flatten(), bins)
            target_dist, _ = np.histogram(target_profile.flatten(), bins)

            dist_error = np.mean((target_dist - pred_dist) ** 2) / (lr.shape[-1] ** 2)
            value_error = abs(target_profile.mean() - pred_profile.mean())
            metrics.append(dist_error + value_error)
        return sum(metrics) / len(metrics)
