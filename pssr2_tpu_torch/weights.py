"""Carry weights from the JAX package to the port.

The JAX package saves weights as a flat ``.npz`` (pssr2_tpu/checkpoint.py:
``save_weights`` / ``_flatten_state``), keyed by module path:
``"encoder/0/convs/1/kernel"``, ``"encoder/0/norms/1/var"``,
``"norm/scale"``, ``"reconstruction/pre/bias"``,
``"encoder/stages/0/blocks/1/layers/fc1/kernel"``, ...  The port's
``state_dict`` uses the reference ``.pth`` names (pssr2_tpu/torch_import.py:
171-247): ``encoder.0.conv.3.weight``, ``encoder.0.conv.4.running_var``,
``norm.weight``, ``reconstruction.pre.bias``,
``encoder.dense_stages.0.0.dense_block1.layers.layers.2.weight``, ...
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
# RDResUNet's encoder (pssr2_tpu/torch_import.py:171-198 for the .pth names)
_LN = {"scale": "weight", "bias": "bias"}
_STEM = re.compile(r"encoder/stem/(conv|norm/norm)/(\w+)")
_TRANSITION = re.compile(r"encoder/transitions/(\d+)/(0/norm|1)/(\w+)")
_GAMMA = re.compile(r"encoder/stages/(\d+)/blocks/(\d+)/gamma")
_LAYER = re.compile(r"encoder/stages/(\d+)/blocks/(\d+)/layers/(dw|fc1|fc2|ese/fc|norm/norm)/(\w+)")
_LAYER_POS = {"dw": "0", "norm/norm": "1", "fc1": "2", "fc2": "4", "ese/fc": "5.fc"}


def _dense_block(stage: str, block: str) -> str:
    # dense_stages.{i} is [LayerNorm2d, conv,] DenseStage: the stage sits at 2
    # after a transition, and every stage but the first has one
    return f"encoder.dense_stages.{stage}.{0 if stage == '0' else 2}.dense_block{block}"


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
    elif m := _STEM.fullmatch(key):
        part, leaf = m.groups()
        names = _CONV if part == "conv" else _LN
        if leaf in names:
            return f"encoder.stem.stem.{0 if part == 'conv' else 1}.{names[leaf]}"
    elif m := _TRANSITION.fullmatch(key):
        i, part, leaf = m.groups()
        names = _CONV if part == "1" else _LN
        if leaf in names:
            return f"encoder.dense_stages.{i}.{part[0]}.{names[leaf]}"
    elif m := _GAMMA.fullmatch(key):
        return f"{_dense_block(*m.groups())}.gamma"
    elif m := _LAYER.fullmatch(key):
        stage, block, part, leaf = m.groups()
        names = _LN if part == "norm/norm" else _CONV
        if leaf in names:
            return f"{_dense_block(stage, block)}.layers.layers.{_LAYER_POS[part]}.{names[leaf]}"
    raise KeyError(
        f"JAX weight {key!r} has no place in the port's ResUNet or RDResUNet "
        "(ResUNetA, RDResUNetA, the PSP pooling variants and SwinIR are not ported yet)"
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


class _Draws:
    """Seeded weights in the JAX flat layout, drawn with numpy into ``flat``:
    convs from the JAX init (torch's default: U(+-1/sqrt(fan_in)) for
    kernel and bias, HWIO kernels), BatchNorms with running statistics and
    affines drawn around identity, so that every BatchNorm does work, and
    LayerNorm affines around identity."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.flat = {}

    def conv(self, path, k, ci, co, groups=1):
        bound = 1.0 / np.sqrt(ci // groups * k * k)
        self.flat[f"{path}/kernel"] = self.rng.uniform(-bound, bound, (k, k, ci // groups, co)).astype(np.float32)
        self.flat[f"{path}/bias"] = self.rng.uniform(-bound, bound, (co,)).astype(np.float32)

    def norm(self, path, c):
        self.flat[f"{path}/mean"] = self.rng.normal(0, 0.1, c).astype(np.float32)
        self.flat[f"{path}/var"] = self.rng.uniform(0.5, 1.5, c).astype(np.float32)
        self.layernorm(path, c)

    def layernorm(self, path, c):
        self.flat[f"{path}/scale"] = self.rng.uniform(0.8, 1.2, c).astype(np.float32)
        self.flat[f"{path}/bias"] = self.rng.normal(0, 0.1, c).astype(np.float32)

    def block(self, path, ci, co, depth):
        for j in range(max(depth, 0) + 1):
            self.conv(f"{path}/convs/{j}", 3, ci if j == 0 else co, co)
            self.norm(f"{path}/norms/{j}", co)
        self.conv(f"{path}/respass", 1, ci, co)


def seeded_jax_params(hidden=None, depth=3, channels=1, scale=4, seed=0) -> dict:
    """Random weights for ``ResUNet(hidden, depth, channels, scale)`` in the
    JAX package's flat layout, drawn from ``seed`` (see :class:`_Draws`)."""
    hidden = [64, 128, 256, 512, 1024] if hidden is None else list(hidden)
    cin, cout = (channels, channels) if isinstance(channels, int) else channels
    draw = _Draws(seed)
    draw.norm("norm", cin)
    layers = [cin, *hidden]
    n = len(layers) - 1
    for i in range(n):
        draw.block(f"encoder/{i}", layers[i], layers[i + 1], depth)
        if i + 1 < n:
            draw.block(f"decoder/{i}", layers[-i - 1] - int(layers[-i - 2] / 2), layers[-i - 2], depth)
    draw.conv("reconstruction/pre", 3, hidden[0] + cin, scale**2 * hidden[0])
    draw.conv("reconstruction/conv", 3, hidden[0], cout)
    return draw.flat


def seeded_rdresunet_params(hidden=None, depth=3, channels=1, scale=4, rdnet_init=128, growth_rates=None,
                            ds_blocks=None, ese_blocks=None, n_blocks=3, patch_size=2, bottleneck=4,
                            compression=0.5, seed=0) -> dict:
    """Random weights for ``RDResUNet`` with these arguments (the JAX
    constructor's defaults) in the JAX package's flat layout, drawn from
    ``seed`` (see :class:`_Draws`), with the layer scales ``gamma`` in
    [0.5, 1] rather than at their 1e-6 init, so that every dense block's
    output, and with it the fused tail, shows in the model's output."""
    hidden = [1024, 1024, 512, 256] if hidden is None else list(hidden)
    growth_rates = [64, 104, 128, 128, 128, 128, 224] if growth_rates is None else list(growth_rates)
    ds_blocks = [False, True, True, False, False, False, True] if ds_blocks is None else list(ds_blocks)
    ese_blocks = [False, False, True, True, True, True, True] if ese_blocks is None else list(ese_blocks)
    n_blocks = [n_blocks] * len(growth_rates) if isinstance(n_blocks, int) else list(n_blocks)
    cin, cout = (channels, channels) if isinstance(channels, int) else channels
    draw = _Draws(seed)
    draw.norm("norm", cin)
    draw.conv("encoder/stem/conv", patch_size, cin, rdnet_init)
    draw.layernorm("encoder/stem/norm/norm", rdnet_init)
    features, skips = rdnet_init, []
    for i, (growth, nb) in enumerate(zip(growth_rates, n_blocks)):
        if i != 0:
            if ds_blocks[i]:
                skips.append(features)
            k, compressed = (2 if ds_blocks[i] else 1), int(features * compression / 8) * 8
            draw.layernorm(f"encoder/transitions/{i}/0/norm", features)
            draw.conv(f"encoder/transitions/{i}/1", k, features, compressed)
            features = compressed
        for b in range(nb):
            p = f"encoder/stages/{i}/blocks/{b}"
            inter = int(features * bottleneck / 8) * 8
            draw.flat[f"{p}/gamma"] = draw.rng.uniform(0.5, 1.0, growth).astype(np.float32)
            draw.conv(f"{p}/layers/dw", 7, features, features, groups=features)
            draw.layernorm(f"{p}/layers/norm/norm", features)
            draw.conv(f"{p}/layers/fc1", 1, features, inter)
            draw.conv(f"{p}/layers/fc2", 1, inter, growth)
            if ese_blocks[i]:
                draw.conv(f"{p}/layers/ese/fc", 1, growth, growth)
            features += growth
    # the decoder takes the skips deepest first, each beside the shuffled
    # output of the block before it
    skips = [features, *skips[::-1]]
    ratios = [1] + [2] * (len(skips) - 1) + [patch_size]
    layers = [0, *hidden]
    for i in range(len(hidden)):
        draw.block(f"decoder/{i}", layers[i] // ratios[i] ** 2 + skips[i], layers[i + 1], depth)
    head = hidden[-1] // patch_size**2
    draw.conv("reconstruction/pre", 3, head + cin, scale**2 * head)
    draw.conv("reconstruction/conv", 3, head, cout)
    return draw.flat
