"""Post-training int8 quantization of the eval forward (the serving path)
(counterpart: pssr2_tpu/quant.py; the reference has no quantization).

Scheme (static symmetric PTQ, W8A8, as the JAX package):
- weights: per-output-channel int8 scales (max-abs / 127);
- activations: per-tensor int8 scales, calibrated by running the float
  forward over user-supplied batches and recording max-abs at every conv
  input;
- each conv runs int8 x int8 -> int32, then ONE f32 per-channel affine that
  folds dequantization, the conv bias and the following eval BatchNorm
  (``y = acc * alpha + beta``) before the ReLU; the glue between convs
  stays in the model's compute dtype (f32 or bf16).

Every int8 conv runs through ``ops/q8chain.py`` (the q8chain kernel on the
card; PyTorch has no int8 convolution on CUDA).  Within a ResBlock, the
suffix of 3x3 layers whose channel counts are multiples of 32 runs as a
chain (JAX's ``_chain_split``, without its TPU gates: pack factor, VMEM
footprint, backend): quantized once, requantized mid-chain inside the
kernel, the glue dtype at its tail.  The other convs (the entry conv with
Cin 1, the residual 1x1s, the reconstruction's pre-conv, unaligned
layers) quantize their input, run the kernel and emit the glue dtype
(``_qconv``).  JAX's default leaves its chain kernel off
(``q8chain.MODE = "off"``) and runs every conv per-conv; chain and per-conv
differ only by the glue round trip mid-chain.

:class:`QuantizedResUNet` and :class:`QuantizedRDResUNet` (the RDNet
encoder kept in floating point, through its rdtail kernel) are eval-only
``nn.Module``s holding the int8 weights and affines as buffers, with the
models' NCHW [0, 255] contract; ``.to(device)`` moves them.  The
reconstruction computes pixel shuffle, then its float conv: JAX's
``fused_head`` is a TPU layout of the same function.  The atrous and PSP
variants (``ResUNetA``, ``ResBlockA``, ``PSPPooling``) are not ported.
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .models.blocks import ResBlock, conv_nhwc
from .ops.convchain import fused_conv_layer
from .ops.pooling import max_pool_2x2
from .ops.q8chain import kernel_weight, q8_conv_layer
from .ops.shuffle import pixel_shuffle

_UNPORTED = "ResUNetA, ResBlockA and PSP pooling are not ported yet (ROADMAP queue 1 item 3)"


def _weight_scales(weight):
    """Per-output-channel symmetric int8 quantization of a (Cout, Cin, K,
    K) kernel: (int8 kernel, f32 (Cout,) scales)."""
    k = weight.detach().float()
    s = k.abs().amax(dim=(1, 2, 3)) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s)
    return torch.round(k / s[:, None, None, None]).to(torch.int8), s


def quantize_tensor(x, inv_scale):
    """Symmetric per-tensor int8: clip(round(x / s), -127, 127), the
    product ``x * (1 / s)`` in f32."""
    return torch.clamp(torch.round(x.float() * inv_scale), -127, 127).to(torch.int8)


def _bn_affine(norm):
    """Eval-mode BatchNorm as a per-channel affine (a, c): y = a*x + c."""
    a = torch.rsqrt(norm.running_var + norm.eps) * norm.weight.detach()
    return a, norm.bias.detach() - norm.running_mean * a


def _conv_entry(conv, norm, amax):
    """One quantized conv site: the int8 kernel and the fused dequant
    affine (alpha, beta) folding the activation scale, the weight scales,
    the conv bias and the following eval BatchNorm."""
    w8, sw = _weight_scales(conv.weight)
    sx = torch.clamp(torch.tensor(amax, dtype=torch.float32, device=w8.device) / 127.0, min=1e-12)
    bias = conv.bias.detach().float() if conv.bias is not None else torch.zeros_like(sw)
    if norm is not None:
        a, c = _bn_affine(norm)
        alpha, beta = sx * sw * a, bias * a + c
    else:
        alpha, beta = sx * sw, bias
    return {"w8": w8, "alpha": alpha, "beta": beta, "inv_sx": 1.0 / sx}


class _QConv(nn.Module):
    """One int8 conv site: ``w8`` (Cout, Cin, K, K), its kernel form ``wk``,
    ``alpha``, ``beta``, ``inv_sx`` (the input's 1/scale) and ``affine``, the
    (2, Cout) affine the kernel applies: (alpha, beta), or (alpha, beta)
    times the next layer's ``inv_sx`` for a mid-chain layer."""

    def __init__(self, entry, inv_next=None):
        super().__init__()
        for name in ("w8", "alpha", "beta", "inv_sx"):
            self.register_buffer(name, entry[name])
        self.register_buffer("wk", kernel_weight(entry["w8"]))
        scale = 1.0 if inv_next is None else inv_next
        self.register_buffer("affine", torch.stack([entry["alpha"] * scale, entry["beta"] * scale]).contiguous())
        self.mid = inv_next is not None

    def run(self, x8, glue):
        """int8 ``x8`` -> int8 (mid-chain) or ``glue``."""
        return q8_conv_layer(x8, self.w8, self.affine, last=not self.mid, out_dtype=glue, wk=self.wk)

    def forward(self, x, glue):
        """Per-conv (``_qconv``): quantize ``x``, the int8 conv, the glue dtype out."""
        return self.run(quantize_tensor(x, self.inv_sx), glue)


def chain_split(shapes):
    """First layer of a ResBlock's conv stack, given each layer's (Cout,
    Cin, K, K) weight shape, from which the suffix runs as a chain: 3x3
    layers with Cin and Cout multiples of 32
    (pssr2_tpu/ops/pallas/q8chain.py:77-78); ``len(shapes)`` when none does."""
    split = len(shapes)
    for i in range(len(shapes) - 1, -1, -1):
        cout, cin, k, _ = shapes[i]
        if k != 3 or cin % 32 or cout % 32:
            break
        split = i
    return split


class _QResBlock(nn.Module):
    """A ResBlock's int8 convs: the per-conv prefix, the chained suffix and
    the residual 1x1."""

    def __init__(self, entries, res_entry):
        super().__init__()
        self.split = chain_split([e["w8"].shape for e in entries])
        self.convs = nn.ModuleList(
            _QConv(e, entries[i + 1]["inv_sx"] if self.split <= i < len(entries) - 1 else None)
            for i, e in enumerate(entries)
        )
        self.res = _QConv(res_entry)

    def forward(self, x, glue):
        n = len(self.convs)
        h = x
        for i in range(self.split):
            h = self.convs[i](h, glue)
            if i + 1 < n:
                h = torch.relu(h)
        if self.split < n:
            # the chain quantizes once (the prefix already applied its ReLU)
            h = quantize_tensor(h, self.convs[self.split].inv_sx)
            for i in range(self.split, n):
                h = self.convs[i].run(h, glue)
        return torch.relu(h + self.res(x, glue))


class _QRecon(nn.Module):
    """The reconstruction head: the int8 pre-conv, ReLU, pixel shuffle and
    the float conv in the glue dtype."""

    def __init__(self, rec, amax):
        super().__init__()
        self.pre = _QConv(_conv_entry(rec.pre, None, amax))
        self.register_buffer("post_weight", rec.conv.weight.detach().float().clone())
        self.register_buffer("post_bias", rec.conv.bias.detach().float().clone())
        self.scale = rec.scale

    def forward(self, x, glue):
        y = pixel_shuffle(torch.relu(self.pre(x, glue)), self.scale)
        out = F.conv2d(y.permute(0, 3, 1, 2), self.post_weight.to(glue), padding=1)
        return out.permute(0, 2, 3, 1) + self.post_bias.to(glue)


class _Observer:
    """Float engine: runs the model's own modules, recording the max-abs
    of every conv input (per site, over all batches)."""

    def __init__(self):
        self.amax = {}

    def _obs(self, key, x):
        m = x.float().abs().max()
        self.amax[key] = torch.maximum(self.amax[key], m) if key in self.amax else m

    def resblock(self, site, blk, x):
        if not isinstance(blk, ResBlock):
            raise NotImplementedError(_UNPORTED)
        self._obs(f"{site}.in", x)
        h = x
        for i in range(blk.n_layers):
            cv, norm = blk.conv[3 * i], blk.conv[3 * i + 1]
            h, _, _ = fused_conv_layer(h, cv.weight, cv.bias)
            h = norm(h)
            if i + 1 < blk.n_layers:
                h = torch.relu(h)
                self._obs(f"{site}.l{i + 1}", h)
        return torch.relu(h + conv_nhwc(x, blk.respass))

    def recon(self, site, rec, x):
        self._obs(f"{site}.in", x)
        return rec(x)


class _Int8Engine:
    """int8 engine: the quantized modules in the glue dtype."""

    def __init__(self, glue):
        self.glue = glue

    def resblock(self, site, blk, x):
        return blk(x, self.glue)

    def recon(self, site, rec, x):
        return rec(x, self.glue)


def _flow(encoder, decoder, recon, x, eng):
    """The ResUNet's eval traversal after its input norm, shared by the
    float observer and the int8 executor (pssr2_tpu/quant.py:511-542)."""
    skips = [x]
    for idx, blk in enumerate(encoder):
        x = eng.resblock(f"enc{idx}", blk, x)
        if idx + 1 < len(encoder):
            skips.append(x)
            x = max_pool_2x2(x)
    for idx, blk in enumerate(decoder):
        x = pixel_shuffle(x, 2)
        x = eng.resblock(f"dec{idx}", blk, torch.cat([x, skips.pop()], dim=-1))
    return eng.recon("recon", recon, torch.cat([x, skips.pop()], dim=-1))


def _rd_decoder_flow(x, feats, eng, decoder, ratios, recon):
    """RDResUNet's decoder-side traversal, shared by the float observer and
    the int8 executor (pssr2_tpu/quant.py:720-734)."""
    skips = [x] + list(feats)
    h = None
    for idx, blk in enumerate(decoder):
        h = skips.pop() if idx == 0 else torch.cat([h, skips.pop()], dim=-1)
        h = eng.resblock(f"dec{idx}", blk, h)
        h = pixel_shuffle(h, ratios[idx + 1])
    return eng.recon("recon", recon, torch.cat([h, skips.pop()], dim=-1))


def _nhwc_in(x, dtype):
    """NCHW [0, 255] -> NHWC ``x/128 - 1`` in ``dtype``."""
    x = (x.float() / 128.0 - 1.0).permute(0, 2, 3, 1)
    return x if dtype is None else x.to(dtype)


def _nchw_out(y):
    return y.permute(0, 3, 1, 2).float() * 128.0 + 128.0


class _Quantized(nn.Module):
    """Eval-only: ``train()`` keeps every submodule in eval mode."""

    def train(self, mode=True):
        return super().train(False)

    @property
    def glue(self):
        return torch.float32 if self.dtype is None else self.dtype


class QuantizedResUNet(_Quantized):
    """int8 (W8A8) eval executor of a ResUNet with the model's NCHW [0, 255]
    contract.  Build with :func:`quantize_resunet`."""

    def __init__(self, encoder, decoder, recon, norm_ac, dtype, scale):
        super().__init__()
        self.encoder, self.decoder, self.recon = nn.ModuleList(encoder), nn.ModuleList(decoder), recon
        self.register_buffer("norm_a", norm_ac[0].clone())
        self.register_buffer("norm_c", norm_ac[1].clone())
        self.dtype, self.scale = dtype, scale
        self.eval()

    def forward(self, x):
        """(N, C, H, W) float [0, 255] -> (N, C_out, H*scale, W*scale) float32."""
        x = _nhwc_in(x, self.dtype)
        x = x * self.norm_a.to(x.dtype) + self.norm_c.to(x.dtype)
        return _nchw_out(_flow(self.encoder, self.decoder, self.recon, x, _Int8Engine(self.glue)))


class QuantizedRDResUNet(_Quantized):
    """Hybrid int8 RDResUNet executor (NCHW [0, 255] contract): the RDNet
    encoder and the input norm stay the model's float modules (shared with
    it, in eval mode; the encoder through its rdtail kernel); the decoder's
    ResBlocks and the reconstruction run W8A8 as in
    :class:`QuantizedResUNet`."""

    def __init__(self, norm, encoder, decoder, recon, ratios, dtype, scale):
        super().__init__()
        self.norm, self.encoder = norm, encoder
        self.decoder, self.recon = nn.ModuleList(decoder), recon
        self.ratios, self.dtype, self.scale = list(ratios), dtype, scale
        self.eval()

    def forward(self, x):
        x = self.norm(_nhwc_in(x, self.dtype).contiguous())
        feats = self.encoder(x)
        return _nchw_out(_rd_decoder_flow(x, feats, _Int8Engine(self.glue), self.decoder, self.ratios, self.recon))


def _assert_eval(model):
    """Every module must be in eval mode (BatchNorm on running statistics,
    DropPath off)."""
    for name, mod in model.named_modules():
        if mod.training:
            raise ValueError(
                "model must be in eval mode (model.eval()) before quantization; "
                f"{name or type(mod).__name__} ({type(mod).__name__}) is in train mode."
            )


def _calibrate(model, batches, observe):
    """Per-site max-abs over ``batches`` (NCHW [0, 255]) as python floats."""
    device = next(model.parameters()).device
    batches = [torch.as_tensor(np.asarray(b, np.float32)) for b in batches]
    if not batches:
        raise ValueError("calib_batches must contain at least one batch.")
    eng = _Observer()
    with torch.inference_mode():
        for b in batches:
            observe(eng, b.to(device))
    return {k: float(v) for k, v in eng.amax.items()}


def _build_blocks(blocks, prefix, amax):
    out = []
    for idx, blk in enumerate(blocks):
        if not isinstance(blk, ResBlock):
            raise NotImplementedError(_UNPORTED)
        site = f"{prefix}{idx}"
        entries = [
            _conv_entry(blk.conv[3 * i], blk.conv[3 * i + 1], amax[f"{site}.in" if i == 0 else f"{site}.l{i}"])
            for i in range(blk.n_layers)
        ]
        out.append(_QResBlock(entries, _conv_entry(blk.respass, None, amax[f"{site}.in"])))
    return out


def calibrate_from_dataset(dataset, n_batches: int = 4, batch_size: int = 8):
    """LR calibration batches from a dataset for :func:`quantize_resunet`.

    Uses the train split when the dataset has one (the distribution the
    model was fit on), else the validation indices (e.g. a ``val_split=1``
    predict-mode dataset).  Works for paired and ``is_lr`` datasets.
    """
    val = set(dataset.val_idx)
    idx = [i for i in range(len(dataset)) if i not in val] or list(dataset.val_idx)
    batches = []
    for s in range(0, min(len(idx), n_batches * batch_size), batch_size):
        items = [dataset[i] for i in idx[s : s + batch_size]]
        lr = [np.asarray(it if dataset.is_lr else it[1], np.float32) for it in items]
        batches.append(np.stack(lr))
    return batches


def quantize_resunet(model, calib_batches):
    """Calibrate and quantize an eval-mode :class:`~pssr2_tpu_torch.models.ResUNet`.

    Args:
        model : eval-mode ResUNet (the plain family; ``ResUNetA`` and PSP
            pooling are not ported).

        calib_batches : iterable of NCHW [0, 255] arrays (the LR inputs the
            model will serve, e.g. :func:`calibrate_from_dataset`).

    Returns:
        :class:`QuantizedResUNet`, on the model's device.
    """
    from .models.resunet import ResUNet

    if not isinstance(model, ResUNet):
        raise NotImplementedError(
            f"quantize_resunet supports the ResUNet family; got {type(model).__name__}. "
            "For RDResUNet use quantize_rdresunet."
        )
    _assert_eval(model)

    def observe(eng, x):
        _flow(model.encoder, model.decoder, model.reconstruction, model.norm(_nhwc_in(x, model.dtype).contiguous()),
              eng)

    amax = _calibrate(model, calib_batches, observe)
    with torch.no_grad():
        return QuantizedResUNet(
            _build_blocks(model.encoder, "enc", amax), _build_blocks(model.decoder, "dec", amax),
            _QRecon(model.reconstruction, amax["recon.in"]), _bn_affine(model.norm), model.dtype, model.scale,
        )


def quantize_rdresunet(model, calib_batches):
    """Calibrate and hybrid-quantize an eval-mode
    :class:`~pssr2_tpu_torch.models.RDResUNet`: float RDNet encoder, int8
    decoder and reconstruction.  Same calibration contract as
    :func:`quantize_resunet`."""
    from .models.rdresunet import RDResUNet

    if not isinstance(model, RDResUNet):
        raise NotImplementedError(f"quantize_rdresunet supports RDResUNet; got {type(model).__name__}.")
    _assert_eval(model)

    def observe(eng, x):
        x = model.norm(_nhwc_in(x, model.dtype).contiguous())
        _rd_decoder_flow(x, model.encoder(x), eng, model.decoder, model.ratios, model.reconstruction)

    amax = _calibrate(model, calib_batches, observe)
    with torch.no_grad():
        return QuantizedRDResUNet(
            model.norm, model.encoder, _build_blocks(model.decoder, "dec", amax),
            _QRecon(model.reconstruction, amax["recon.in"]), model.ratios, model.dtype, model.scale,
        )
