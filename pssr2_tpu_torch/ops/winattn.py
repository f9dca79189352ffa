"""Window attention, softmax(q k^T * scale + bias [+ shift mask]) v per
window, and its plain PyTorch versions.

Counterpart: pssr2_tpu/ops/pallas/winattn.py: ``fused_window_attention``
(331) over (W, n, 3C) windows and ``fused_window_attention_2d`` (275) over
the (B, H, W, 3C) image, kernels ``_attn_kernel(_masked)`` (46/68) and
``_attn_kernel_2d(_masked)`` (121/147), oracles
``reference_window_attention`` (215) and ``reference_window_attention_2d``
(232); and ``_shift_attn_mask`` of pssr2_tpu/models/swinir.py:71.

The two JAX functions compute one function in two layouts, so the port has
one CUDA kernel (``swin_winattn`` in ``csrc/swinblock.cu``) that reads the
windows of an image in place: the (W, n, 3C) form is an image of W rows of
one n-token window each.  Its arithmetic is the Pallas kernel's: the
scores q k^T in f32, then ``s * scale + bias [+ mask]`` in f32, a
max-subtracted f32 softmax rounded to the compute dtype, and p v with f32
accumulation rounded to the dtype.

As in JAX there is no backward kernel: the gradient recomputes through the
plain version under autograd.  For a CPU tensor the forward takes the
plain version; a CUDA tensor launches the kernel or raises.
"""

import ctypes
import functools

import numpy as np
import torch

from . import cuda_build

# Launches of the CUDA kernel in this process (the plain versions do not count).
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VOID_P, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# What the kernel takes: windows of up to MAX_N tokens (8 x 8) and heads of
# up to MAX_HEAD_DIM channels (one head's q, k, v and its 64 x 64
# probabilities sit in shared memory at a time, so C is free).
MAX_N = 64
MAX_HEAD_DIM = 32

# Agreement of the kernel with the plain version on the same inputs, as
# max |error| over max |ref|: in f32 only the order of the sums differs;
# in bf16 one f32 ulp can move the rounding of a probability or of an
# output by one bf16 ulp, so 2 bf16 ulps of the largest output.
TOLERANCE = {torch.float32: 1e-5, torch.bfloat16: 1 / 64}

NEG = -100.0  # the shift mask's fill value (pssr2_tpu/models/swinir.py:88)


@functools.lru_cache(maxsize=64)
def shift_attn_mask(h, w, window_size, shift_size):
    """(nW, n, n) f32 attention mask of the shifted windows of an h x w
    image, -100 between tokens of different regions of the rolled image,
    else 0; None when ``shift_size`` is 0 (pssr2_tpu/models/swinir.py:71)."""
    if shift_size == 0:
        return None
    img = np.zeros((h, w))
    sl = (slice(0, -window_size), slice(-window_size, -shift_size), slice(-shift_size, None))
    cnt = 0
    for hs in sl:
        for ws in sl:
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(h // window_size, window_size, w // window_size, window_size)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, NEG, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _mask_tensor(mask_spec, device):
    """:func:`shift_attn_mask` on ``device``, copied there once per spec
    (a copy from pageable host memory would wait for the card each time).
    Callers must not write to it."""
    mask = None if mask_spec is None else shift_attn_mask(*mask_spec)
    return None if mask is None else torch.from_numpy(mask).to(device)


def heads_of(t, heads):
    """(Wn, n, heads * d) -> (Wn, heads, n, d)."""
    wn, n, c = t.shape
    return t.reshape(wn, n, heads, c // heads).transpose(1, 2)


def split_qkv(qkv, heads):
    """(Wn, n, 3C) -> q, k, v as (Wn, heads, n, d)."""
    c = qkv.shape[-1] // 3
    return tuple(heads_of(qkv[..., i * c : (i + 1) * c], heads) for i in range(3))


def attention_probs(q, k, bias, mask, scale, max_subtract):
    """The f32 probabilities of one window batch: q, k (Wn, heads, n, d) in
    the dtype, bias (heads, n, n) f32, mask (nW, n, n) f32 or None (window
    w takes mask[w % nW]).  ``scale`` None skips the multiply (the block's
    folded scale).  ``max_subtract``: the Pallas kernels' jax.nn.softmax,
    exp(s - max) / sum; otherwise the whole-block kernel's no-max form,
    exp(s) * (1 / sum)."""
    s = q.float() @ k.float().transpose(-1, -2)
    if scale is not None:
        s = s * scale
    s = s + bias.float()
    if mask is not None:
        wn, heads, n, _ = s.shape
        s = (s.reshape(-1, mask.shape[0], heads, n, n) + mask.float()[:, None]).reshape(wn, heads, n, n)
    if max_subtract:
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        return e / e.sum(dim=-1, keepdim=True)
    e = torch.exp(s)
    return e * (1.0 / e.sum(dim=-1, keepdim=True))


def attention_out(p32, v):
    """(p rounded to v's dtype) v with f32 accumulation, rounded; (Wn,
    heads, n, d) -> (Wn, n, heads * d)."""
    o = (p32.to(v.dtype).float() @ v.float()).to(v.dtype)
    wn, heads, n, d = o.shape
    return o.transpose(1, 2).reshape(wn, n, heads * d)


def reference_window_attention(qkv, bias, mask, scale, heads):
    """Plain version of the kernel on (W, n, 3C) windows, features ordered
    q | k | v; bias (heads, n, n); mask (nW, n, n) or None.  -> (W, n, C)
    in qkv's dtype."""
    q, k, v = split_qkv(qkv, heads)
    return attention_out(attention_probs(q, k, bias, mask, scale, True), v)


def windows(x, ws):
    """(B, H, W, C) -> (B * H/ws * W/ws, ws * ws, C), windows row-major
    (pssr2_tpu/models/swinir.py:window_partition at 44)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def unwindows(t, ws, b, h, w):
    """Inverse of :func:`windows` (window_reverse at 51)."""
    c = t.shape[-1]
    t = t.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, c)


def reference_window_attention_2d(qkv_img, bias, mask, scale, heads, ws):
    """Plain version in the image layout: (B, H, W, 3C) -> (B, H, W, C)."""
    b, h, w, _ = qkv_img.shape
    out = reference_window_attention(windows(qkv_img, ws), bias, mask, scale, heads)
    return unwindows(out, ws, b, h, w)


@functools.cache
def _fn():
    fn = cuda_build.load("swinblock").swin_winattn
    fn.argtypes = [_VOID_P] * 4 + [_INT] * 9 + [_FLOAT, _VOID_P]
    fn.restype = _INT
    return fn


def _check(qkv_img, bias, mask, heads, wh, ww):
    if qkv_img.device.type != "cuda":
        raise ValueError(f"window attention takes CPU or CUDA tensors, got {qkv_img.device}")
    if qkv_img.dtype not in _DTYPE_CODE:
        raise TypeError(f"window attention takes float32 or bfloat16, got {qkv_img.dtype}")
    b, h, w, c3 = qkv_img.shape
    n = wh * ww
    if c3 % (3 * heads) or h % wh or w % ww:
        raise ValueError(f"qkv {tuple(qkv_img.shape)} does not split into {heads} heads of {wh}x{ww} windows")
    if n > MAX_N or c3 // 3 // heads > MAX_HEAD_DIM:
        raise ValueError(
            f"window attention takes windows of up to {MAX_N} tokens and heads of up to {MAX_HEAD_DIM} "
            f"channels, got {n} tokens and {c3 // 3 // heads} channels"
        )
    if tuple(bias.shape) != (heads, n, n):
        raise ValueError(f"bias {tuple(bias.shape)}, want {(heads, n, n)}")
    nwin = b * (h // wh) * (w // ww)
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (n, n) or nwin % mask.shape[0]):
        raise ValueError(f"mask {tuple(mask.shape)} does not fit {nwin} windows of {n} tokens")
    if any(t is not None and t.device != qkv_img.device for t in (bias, mask)):
        raise ValueError("window attention: all inputs must be on qkv's device")


def _launch(qkv_img, bias, mask, scale, heads, wh, ww):
    """The kernel on the windows of wh x ww tokens of the (B, H, W, 3C) image."""
    global launches
    _check(qkv_img, bias, mask, heads, wh, ww)
    b, h, w, c3 = qkv_img.shape
    qkv_img = qkv_img.contiguous()
    bias = bias.detach().float().contiguous()
    mask = None if mask is None else mask.detach().float().contiguous()
    out = torch.empty((b, h, w, c3 // 3), dtype=qkv_img.dtype, device=qkv_img.device)
    with torch.cuda.device(qkv_img.device):
        err = _fn()(
            qkv_img.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(), out.data_ptr(),
            b, h, w, c3 // 3, heads, wh, ww, 0 if mask is None else mask.shape[0], _DTYPE_CODE[qkv_img.dtype],
            float(scale), torch.cuda.current_stream(qkv_img.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"swin_winattn launch failed with CUDA error {err}")
    launches += 1
    return out


class _WindowAttention(torch.autograd.Function):
    """Image layout (B, H, W, 3C), windows of wh x ww tokens."""

    @staticmethod
    def forward(ctx, qkv_img, bias, mask, scale, heads, wh, ww):
        ctx.save_for_backward(qkv_img, bias)
        ctx.cfg = (mask, scale, heads, wh, ww)
        if qkv_img.device.type == "cpu":
            return _plain_image(qkv_img, bias, mask, scale, heads, wh, ww)
        return _launch(qkv_img, bias, mask, scale, heads, wh, ww)

    @staticmethod
    def backward(ctx, gout):
        qkv_img, bias = ctx.saved_tensors
        mask, scale, heads, wh, ww = ctx.cfg
        with torch.enable_grad():
            a, b_ = qkv_img.detach().requires_grad_(), bias.detach().requires_grad_()
            out = _plain_image(a, b_, mask, scale, heads, wh, ww)
            ga, gb = torch.autograd.grad(out, (a, b_), gout)
        return ga, gb, None, None, None, None, None


def _plain_image(qkv_img, bias, mask, scale, heads, wh, ww):
    """The plain version on wh x ww windows of the image."""
    if wh == ww:
        return reference_window_attention_2d(qkv_img, bias, mask, scale, heads, wh)
    b, h, w, c3 = qkv_img.shape  # (W, 1, n, 3C) of fused_window_attention: one window a row
    return reference_window_attention(qkv_img.reshape(b * h, w, c3), bias, mask, scale, heads).reshape(b, h, w, -1)


def fused_window_attention(qkv, bias, mask_spec, scale, heads):
    """qkv (W, n, 3C) -> (W, n, C); bias (heads, n, n) differentiable;
    ``mask_spec`` None or the (h, w, window_size, shift_size) key of
    :func:`shift_attn_mask` (window w takes mask[w % nW]).  The counterpart
    of JAX's (W, n, 3C) entry point; no model path calls it, since the
    model's per-block eval path reads the windows in place through
    :func:`fused_window_attention_2d`."""
    w, n, c3 = qkv.shape
    mask = _mask_tensor(mask_spec, qkv.device)
    out = _WindowAttention.apply(qkv.reshape(w, 1, n, c3), bias, mask, float(scale), heads, 1, n)
    return out.reshape(w, n, c3 // 3)


def fused_window_attention_2d(qkv_img, bias, mask_spec, scale, heads, ws):
    """Image layout: qkv (B, H, W, 3C) -> (B, H, W, C), the ws x ws windows
    read in place (no window partition or reverse)."""
    mask = _mask_tensor(mask_spec, qkv_img.device)
    return _WindowAttention.apply(qkv_img, bias, mask, float(scale), heads, ws, ws)


def fits(n, head_dim) -> bool:
    """Whether the kernel takes windows of n tokens and heads of head_dim
    channels."""
    return n <= MAX_N and head_dim <= MAX_HEAD_DIM
