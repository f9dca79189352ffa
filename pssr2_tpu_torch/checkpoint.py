"""Checkpointing (counterpart: pssr2_tpu/checkpoint.py:21-150; reference:
pssr/train.py:151-153, pssr/__main__.py:99-102).

Weights are the reference's own format: a ``.pth`` ``state_dict`` in the
reference key layout (``torch.save``); ``load_weights`` also reads the JAX
package's flat ``.npz`` through ``weights.params_from_jax``.  The full
train state (model, optimizer state and the completed-epoch counter) is
one ``torch.save`` file per epoch, ``epoch_<n>.pt``, written to a
temporary name and renamed, so a crash mid-write never leaves a partial
checkpoint; the newest two are kept.  The JAX package writes that state
with orbax, which the card's machine lacks.  ``save_train_state`` /
``load_train_state`` are not ported yet.
"""

import os
import re
import tempfile
from pathlib import Path

import torch

from .weights import load_jax_weights

_EPOCH = re.compile(r"epoch_(\d+)\.pt")


def save_weights(model, path):
    """Save the model's weights and BatchNorm statistics as a ``.pth``
    state_dict (reference layout, CPU tensors)."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def load_weights(model, path):
    """Load weights into ``model``, strictly: a ``.pth`` / ``.pt`` state_dict
    from :func:`save_weights` or the reference, or a JAX ``.npz`` from
    ``pssr2_tpu.checkpoint.save_weights`` (dispatched by extension)."""
    if str(path).endswith(".npz"):
        return load_jax_weights(model, path)
    model.load_state_dict(torch.load(path, map_location="cpu", weights_only=True), strict=True)
    return model


def _epochs(directory: Path):
    return sorted(int(m.group(1)) for p in directory.iterdir() if (m := _EPOCH.fullmatch(p.name)))


def save_full_state(directory, model, optimizer, epoch: int):
    """Fault-tolerance checkpoint: model + optimizer state + completed-epoch
    counter (read back by train_paired's ``state_dir`` resume)."""
    directory = Path(directory).absolute()
    os.makedirs(directory, exist_ok=True)
    payload = {"model": model.state_dict(), "opt": optimizer.state_dict(), "epoch": int(epoch)}
    fd, tmp = tempfile.mkstemp(prefix=".epoch_", suffix=".tmp", dir=directory)
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, directory / f"epoch_{epoch}.pt")
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    for old in _epochs(directory)[:-2]:  # keep the newest two
        (directory / f"epoch_{old}.pt").unlink(missing_ok=True)


def load_full_state(directory, model, optimizer) -> int:
    """Restore the newest fault-tolerance checkpoint into ``model`` and
    ``optimizer``; returns the epoch to resume from (0 when there is none)."""
    directory = Path(directory).absolute()
    if not directory.exists():
        return 0
    epochs = _epochs(directory)
    if not epochs:
        return 0
    device = next(model.parameters()).device
    payload = torch.load(directory / f"epoch_{epochs[-1]}.pt", map_location=device, weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["opt"])
    return int(payload["epoch"])
