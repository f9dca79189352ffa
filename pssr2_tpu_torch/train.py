"""The training step (counterpart: pssr2_tpu/train.py:45-128, 247-300;
reference: pssr/train.py).

One step: (optionally) the device degradation of a uint8 HR batch into an
(hr, lr) pair, the forward, the loss on the [0, 1] scale, the backward and
one optimizer step.  The JAX package jits the step; PyTorch runs it
eagerly, with the hand-written kernels under the model and the loss.
``train_paired`` and checkpoints are not ported yet.
"""

import torch

from .ops.ssim import ssim

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


def _apply_grads(model, optimizer, loss):
    """Backward and one optimizer step.  A parameter that autograd leaves
    without a gradient (the ResBlock conv biases under train-mode
    BatchNorm, detached) gets zeros, so AdamW decays it as optax does."""
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
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
