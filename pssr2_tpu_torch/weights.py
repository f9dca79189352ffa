"""Carry weights from the JAX package to the port.

The JAX package saves weights as a flat ``.npz`` (pssr2_tpu/checkpoint.py:
``save_weights`` / ``_flatten_state``), keyed by module path:
``"encoder/0/convs/1/kernel"``, ``"encoder/0/norms/1/var"``,
``"norm/scale"``, ``"reconstruction/pre/bias"``, ...  The port's
``state_dict`` uses the reference ``.pth`` names (pssr2_tpu/torch_import.py:
201-247): ``encoder.0.conv.3.weight``, ``encoder.0.conv.4.running_var``,
``norm.weight``, ``reconstruction.pre.bias``, ...
"""

import re

import numpy as np
import torch

_BN = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_CONV = {"kernel": "weight", "bias": "bias"}
_BLOCK = re.compile(r"(encoder|decoder)/(\d+)/(convs|norms)/(\d+)/(\w+)")
_RESPASS = re.compile(r"(encoder|decoder)/(\d+)/respass/(\w+)")
_HEAD = re.compile(r"reconstruction/(pre|conv)/(\w+)")
_NORM = re.compile(r"norm/(\w+)")


def _torch_key(key: str) -> str:
    if m := _BLOCK.fullmatch(key):
        part, i, kind, j, leaf = m.groups()
        if kind == "convs" and leaf in _CONV:
            return f"{part}.{i}.conv.{3 * int(j)}.{_CONV[leaf]}"
        if kind == "norms" and leaf in _BN:
            return f"{part}.{i}.conv.{3 * int(j) + 1}.{_BN[leaf]}"
    elif m := _RESPASS.fullmatch(key):
        part, i, leaf = m.groups()
        if leaf in _CONV:
            return f"{part}.{i}.respass.{_CONV[leaf]}"
    elif m := _HEAD.fullmatch(key):
        name, leaf = m.groups()
        if leaf in _CONV:
            return f"reconstruction.{name}.{_CONV[leaf]}"
    elif m := _NORM.fullmatch(key):
        if m.group(1) in _BN:
            return f"norm.{_BN[m.group(1)]}"
    raise KeyError(
        f"JAX weight {key!r} has no place in the port's ResUNet "
        "(ResUNetA and the PSP pooling variants are not ported yet)"
    )


def params_from_jax(flat) -> dict:
    """The port's ``state_dict`` (CPU f32 tensors) from the JAX model's
    flat parameters and batch stats (a mapping of ``/``-joined paths to
    arrays, e.g. ``np.load`` of a ``save_weights`` file).  HWIO conv
    kernels become OIHW.

    Any subset of those keys maps, so the same call carries the JAX
    gradients (the flattened ``nnx.grad`` state: parameters only, named as
    the parameters) to the port's parameter names and layout, and the
    running statistics of a model after a train step, for comparing the
    two packages key by key."""
    out = {}
    for key in flat:
        arr = np.asarray(flat[key], dtype=np.float32)
        if key.endswith("/kernel"):
            arr = np.transpose(arr, (3, 2, 0, 1))  # (kh, kw, I, O) -> (O, I, kh, kw)
        out[_torch_key(key)] = torch.tensor(arr)
    return out


def load_jax_weights(model, path):
    """Load a JAX ``.npz`` (``checkpoint.save_weights``) into ``model``, strictly."""
    with np.load(path) as flat:
        model.load_state_dict(params_from_jax(flat), strict=True)
    return model


def seeded_jax_params(hidden=None, depth=3, channels=1, scale=4, seed=0) -> dict:
    """Random weights for ``ResUNet(hidden, depth, channels, scale)`` in the
    JAX package's flat layout (HWIO kernels), drawn with numpy from
    ``seed``: convs from the JAX init (torch's default: U(+-1/sqrt(fan_in))
    for kernel and bias), and BatchNorms with running statistics and
    affines drawn around identity, so that every BatchNorm does work."""
    hidden = [64, 128, 256, 512, 1024] if hidden is None else list(hidden)
    cin, cout = (channels, channels) if isinstance(channels, int) else channels
    rng = np.random.default_rng(seed)
    flat = {}

    def conv(path, k, ci, co):
        bound = 1.0 / np.sqrt(ci * k * k)
        flat[f"{path}/kernel"] = rng.uniform(-bound, bound, (k, k, ci, co)).astype(np.float32)
        flat[f"{path}/bias"] = rng.uniform(-bound, bound, (co,)).astype(np.float32)

    def norm(path, c):
        flat[f"{path}/mean"] = rng.normal(0, 0.1, c).astype(np.float32)
        flat[f"{path}/var"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        flat[f"{path}/scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
        flat[f"{path}/bias"] = rng.normal(0, 0.1, c).astype(np.float32)

    def block(path, ci, co):
        for j in range(max(depth, 0) + 1):
            conv(f"{path}/convs/{j}", 3, ci if j == 0 else co, co)
            norm(f"{path}/norms/{j}", co)
        conv(f"{path}/respass", 1, ci, co)

    norm("norm", cin)
    layers = [cin, *hidden]
    n = len(layers) - 1
    for i in range(n):
        block(f"encoder/{i}", layers[i], layers[i + 1])
        if i + 1 < n:
            block(f"decoder/{i}", layers[-i - 1] - int(layers[-i - 2] / 2), layers[-i - 2])
    conv("reconstruction/pre", 3, hidden[0] + cin, scale**2 * hidden[0])
    conv("reconstruction/conv", 3, hidden[0], cout)
    return flat
