"""Carry weights from the JAX package to the port.

The JAX package saves weights as a flat ``.npz`` (pssr2_tpu/checkpoint.py:
``save_weights`` / ``_flatten_state``), keyed by module path:
``"encoder/0/convs/1/kernel"``, ``"encoder/0/norms/1/var"``,
``"norm/scale"``, ``"reconstruction/pre/bias"``,
``"encoder/stages/0/blocks/1/layers/fc1/kernel"``,
``"layers/0/residual_group/blocks/1/attn/qkv/kernel"``, ...  The port's
``state_dict`` uses the reference ``.pth`` names (pssr2_tpu/torch_import.py:
106-161, 171-247): ``encoder.0.conv.3.weight``,
``encoder.0.conv.4.running_var``, ``norm.weight``,
``reconstruction.pre.bias``,
``encoder.dense_stages.0.0.dense_block1.layers.layers.2.weight``,
``layers.0.residual_group.blocks.1.attn.qkv.weight``, ...
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
# SwinIR (pssr2_tpu/torch_import.py:106-161 for the .pth names): the blocks'
# norms, linears and bias tables keep their paths; the RSTB and body convs,
# a list in JAX, are one conv ('1conv') or a Sequential at 0, 2, 4 ('3conv')
_SWIN_BLOCK = re.compile(
    r"layers/(\d+)/residual_group/blocks/(\d+)/(norm1|norm2|attn/qkv|attn/proj|mlp/fc1|mlp/fc2)/(\w+)")
_SWIN_TABLE = re.compile(r"layers/(\d+)/residual_group/blocks/(\d+)/attn/relative_position_bias_table")
_SWIN_CONVS = re.compile(r"(layers/(\d+)/convs|conv_after_body)/(\d)/(\w+)")
_SWIN_HEADS = {"conv_first": "conv_first", "conv_before_upsample": "conv_before_upsample.0",
               "upsample_direct": "upsample.0", "conv_up1": "conv_up1", "conv_up2": "conv_up2", "conv_hr": "conv_hr",
               "conv_last": "conv_last"}
_SWIN_HEAD = re.compile(r"(conv_first|conv_before_upsample|upsample_direct|conv_up1|conv_up2|conv_hr|conv_last)/(\w+)")
_SWIN_UPSAMPLE = re.compile(r"upsample/(\d+)/(\w+)")


def _dense_block(stage: str, block: str) -> str:
    # dense_stages.{i} is [LayerNorm2d, conv,] DenseStage: the stage sits at 2
    # after a transition, and every stage but the first has one
    return f"encoder.dense_stages.{stage}.{0 if stage == '0' else 2}.dense_block{block}"


def _torch_key(key: str, three_conv: bool = False) -> str:
    """The port's name of JAX key ``key``; ``three_conv``: the SwinIR's
    residual convs are '3conv' Sequentials."""
    if key == "absolute_pos_embed":
        return key
    if m := _SWIN_BLOCK.fullmatch(key):
        layer, block, part, leaf = m.groups()
        names = _LN if part.startswith("norm") else _CONV
        if leaf in names:
            return f"layers.{layer}.residual_group.blocks.{block}.{part.replace('/', '.')}.{names[leaf]}"
    elif _SWIN_TABLE.fullmatch(key):
        return key.replace("/", ".")
    elif m := _SWIN_CONVS.fullmatch(key):
        part, layer, j, leaf = m.groups()
        if leaf in _CONV:
            base = f"layers.{layer}.conv" if layer is not None else "conv_after_body"
            return f"{base}.{2 * int(j)}.{_CONV[leaf]}" if three_conv else f"{base}.{_CONV[leaf]}"
    elif m := _SWIN_HEAD.fullmatch(key):
        name, leaf = m.groups()
        if leaf in _CONV:
            return f"{_SWIN_HEADS[name]}.{_CONV[leaf]}"
    elif m := _SWIN_UPSAMPLE.fullmatch(key):
        i, leaf = m.groups()
        if leaf in _CONV:
            return f"upsample.{2 * int(i)}.{_CONV[leaf]}"
    elif key.startswith("patch_embed/norm/") and key.rsplit("/", 1)[1] in _LN:
        return f"patch_embed.norm.{_LN[key.rsplit('/', 1)[1]]}"
    elif m := _BLOCK.fullmatch(key):
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
        f"JAX weight {key!r} has no place in the port's ResUNet, RDResUNet or SwinIR "
        "(ResUNetA, RDResUNetA and the PSP pooling variants are not ported yet)"
    )


def params_from_jax(flat) -> dict:
    """The port's ``state_dict`` (CPU f32 tensors) from the JAX model's
    flat parameters and batch stats (a mapping of ``/``-joined paths to
    arrays, e.g. ``np.load`` of a ``save_weights`` file).  HWIO conv
    kernels become OIHW.

    Linear kernels (in, out) become (out, in); SwinIR's bias tables stay
    (n_bias, heads).

    Any subset of those keys maps, so the same call carries the JAX
    gradients (the flattened ``nnx.grad`` state: parameters only, named as
    the parameters) to the port's parameter names and layout, and the
    running statistics of a model after a train step, for comparing the
    two packages key by key.  A SwinIR's residual convs count as '3conv'
    when any key holds the second conv of such a group."""
    three_conv = any(_SWIN_CONVS.fullmatch(k) and _SWIN_CONVS.fullmatch(k).group(3) != "0" for k in flat)
    out = {}
    for key in flat:
        arr = np.asarray(flat[key], dtype=np.float32)
        if key.endswith("/kernel"):
            # (kh, kw, I, O) -> (O, I, kh, kw); (I, O) -> (O, I)
            arr = np.transpose(arr, (3, 2, 0, 1)) if arr.ndim == 4 else arr.T
        out[_torch_key(key, three_conv)] = torch.tensor(np.ascontiguousarray(arr))
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


def _trunc_normal(rng, shape, std=0.02):
    """N(0, std) cut at 2 std (JAX's ``truncated_normal`` init): draws
    outside are redrawn."""
    out = rng.standard_normal(shape)
    bad = np.abs(out) > 2
    while bad.any():
        out[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(out) > 2
    return (std * out).astype(np.float32)


def seeded_swinir_params(image_size=128, channels=1, scale=4, embed_dim=96, mlp_ratio=2, depths=None, num_heads=None,
                         window_size=8, upsampler="pixelshuffle", qkv_bias=True, ape=False, patch_norm=True,
                         resi_connection="1conv", seed=0) -> dict:
    """Random weights for ``SwinIR`` with these arguments (the JAX
    constructor's defaults) in the JAX package's flat layout, drawn from
    ``seed``: the linears, bias tables and ``ape`` from JAX's init
    (truncated normal, std 0.02) with zero linear biases, the convs from the
    torch default (see :class:`_Draws`), and the LayerNorm scales in
    [0.5, 1.5] (biases 0) rather than at 1, so that their gradients are not
    trivial."""
    depths = [4, 4, 4, 4] if depths is None else list(depths)
    num_heads = [6, 6, 6, 6] if num_heads is None else list(num_heads)
    cin, cout = (channels, channels) if isinstance(channels, int) else channels
    draw = _Draws(seed)
    rng, flat = draw.rng, draw.flat
    hidden, num_feat = int(embed_dim * mlp_ratio), 64
    ws = min(window_size, image_size)  # the blocks clamp the window to the image

    def ln(path, c):
        flat[f"{path}/scale"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        flat[f"{path}/bias"] = np.zeros(c, np.float32)

    def lin(path, i, o, bias=True):
        flat[f"{path}/kernel"] = _trunc_normal(rng, (i, o))
        if bias:
            flat[f"{path}/bias"] = np.zeros(o, np.float32)

    def convs(path, c):
        if resi_connection == "1conv":
            draw.conv(f"{path}/0", 3, c, c)
        else:
            draw.conv(f"{path}/0", 3, c, c // 4)
            draw.conv(f"{path}/1", 1, c // 4, c // 4)
            draw.conv(f"{path}/2", 3, c // 4, c)

    draw.conv("conv_first", 3, cin, embed_dim)
    if patch_norm:
        ln("patch_embed/norm", embed_dim)
    if ape:
        flat["absolute_pos_embed"] = _trunc_normal(rng, (1, image_size * image_size, embed_dim))
    for i, (depth, heads) in enumerate(zip(depths, num_heads)):
        for j in range(depth):
            p = f"layers/{i}/residual_group/blocks/{j}"
            ln(f"{p}/norm1", embed_dim)
            lin(f"{p}/attn/qkv", embed_dim, 3 * embed_dim, qkv_bias)
            lin(f"{p}/attn/proj", embed_dim, embed_dim)
            flat[f"{p}/attn/relative_position_bias_table"] = _trunc_normal(rng, ((2 * ws - 1) ** 2, heads))
            ln(f"{p}/norm2", embed_dim)
            lin(f"{p}/mlp/fc1", embed_dim, hidden)
            lin(f"{p}/mlp/fc2", hidden, embed_dim)
        convs(f"layers/{i}/convs", embed_dim)
    ln("norm", embed_dim)
    convs("conv_after_body", embed_dim)
    if upsampler == "pixelshuffle":
        draw.conv("conv_before_upsample", 3, embed_dim, num_feat)
        steps = [4] * int(np.log2(scale)) if (scale & (scale - 1)) == 0 else [9]
        for k, r2 in enumerate(steps):
            draw.conv(f"upsample/{k}", 3, num_feat, r2 * num_feat)
        draw.conv("conv_last", 3, num_feat, cout)
    elif upsampler == "pixelshuffledirect":
        draw.conv("upsample_direct", 3, embed_dim, scale**2 * cout)
    elif upsampler == "nearest+conv":
        draw.conv("conv_before_upsample", 3, embed_dim, num_feat)
        for name in ("conv_up1", "conv_up2") if scale == 4 else ("conv_up1",):
            draw.conv(name, 3, num_feat, num_feat)
        draw.conv("conv_hr", 3, num_feat, num_feat)
        draw.conv("conv_last", 3, num_feat, cout)
    else:
        draw.conv("conv_last", 3, embed_dim, cout)
    return flat
