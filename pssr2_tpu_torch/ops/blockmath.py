"""Plain PyTorch helpers with the rounding of the JAX package's fused
transformer-block kernels: the erf rational, the exact and polynomial
GELU and their derivatives, flax's LayerNorm and its VJP, and nnx.Linear's
product and its VJP.

Counterpart: pssr2_tpu/ops/pallas/swinblock.py (``_erf_f32``,
``_gelu_exact``, ``_gelu_fast``, ``_layernorm``, ``_matmul`` at 53-130;
``_dgelu_fast``, ``_dgelu_exact``, ``_layernorm_bwd``, ``_matmul_dx``,
``_matmul_dw`` at 437-497), copied here so that the port imports nothing of
the JAX package.  The plain versions of the RDNet block tail
(``ops/rdtail.py``) and of the whole Swin block (``ops/swinblock.py``) are
built from them; the CUDA kernels round at the same places.

Tensors are channels-last: every helper acts on the last axis, and the
parameter-gradient sums run over all the leading axes.
"""

import numpy as np
import torch

# XLA's erf rational on [-4, 4] (swinblock.py:53-58)
_ERF_ALPHA = (-2.72614225801306e-10, 2.77068142495902e-08, -2.10102402082508e-06,
              -5.69250639462346e-05, -7.34990630326855e-04, -2.95459980854025e-03,
              -1.60960333262415e-02)
_ERF_BETA = (-1.45660718464996e-05, -2.13374055278905e-04, -1.68282697438203e-03,
             -7.37332916720468e-03, -1.42647390514189e-02)
# gelu(x) = 0.5x + x^2 S(x^2) on [-4, 4] (swinblock.py:86-93), and S'
_GELU_S = (0.398714550644521, -0.0659565049580834, 0.009545222431626374,
           -0.0010175056451836898, 7.648234117739626e-05,
           -3.7887493429360835e-06, 1.0968829398043447e-07,
           -1.3937041721878255e-09)
_GELU_SP = tuple(k * c for k, c in enumerate(_GELU_S))[1:]
_SQRT_HALF = float(np.float32(np.sqrt(0.5)))
_INV_SQRT_2PI = float(np.float32(1.0 / np.sqrt(2.0 * np.pi)))


def _is_fast(dtype):
    """The polynomial GELU for bf16 compute, the exact one for f32
    (the JAX package's ``FAST_GELU = "auto"``)."""
    return dtype == torch.bfloat16


def _erf_f32(x):
    xc = x.clamp(-4.0, 4.0)
    x2 = xc * xc

    def poly(cs):
        a = torch.full_like(x2, cs[0])
        for c in cs[1:]:
            a = a * x2 + c
        return a

    return xc * poly(_ERF_ALPHA) / poly(_ERF_BETA)


def _gelu_exact(x):
    xf = x.float()
    return (0.5 * xf * (1.0 + _erf_f32(xf * _SQRT_HALF))).to(x.dtype)


def _poly_u(u, cs):
    acc = torch.full_like(u, cs[-1])
    for c in cs[-2::-1]:
        acc = acc * u + c
    return acc


def _gelu_fast(x):
    xf = x.float()
    xc = xf.clamp(-4.0, 4.0)
    u = xc * xc
    y = 0.5 * xc + u * _poly_u(u, _GELU_S)
    y = torch.where(xf > 4.0, xf, torch.where(xf < -4.0, torch.zeros_like(y), y))
    return y.to(x.dtype)


def _gelu(x):
    """The kernels' GELU in x's dtype: polynomial for bf16, exact for f32."""
    return _gelu_fast(x) if _is_fast(x.dtype) else _gelu_exact(x)


def _dgelu_fast(x):
    xf = x.float()
    xc = xf.clamp(-4.0, 4.0)
    u = xc * xc
    g = 0.5 + 2.0 * xc * (_poly_u(u, _GELU_S) + u * _poly_u(u, _GELU_SP))
    return torch.where(xf > 4.0, torch.ones_like(g), torch.where(xf < -4.0, torch.zeros_like(g), g))


def _dgelu_exact(x):
    xf = x.float()
    phi = torch.exp(-0.5 * xf * xf) * _INV_SQRT_2PI
    return 0.5 * (1.0 + _erf_f32(xf * _SQRT_HALF)) + xf * phi


def _dgelu(x):
    """f32 derivative of :func:`_gelu` at x (x's dtype picks the form)."""
    return _dgelu_fast(x) if _is_fast(x.dtype) else _dgelu_exact(x)


def _aligned(t):
    """``t`` contiguous, starting on 16 bytes (the tensor-core kernels'
    vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stats(xf):
    """f32 row mean and fast variance max(0, E[x^2] - mu^2), keepdim."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return mu, var


def _layernorm(x, scale, bias, eps):
    """flax nnx.LayerNorm semantics: scale and bias rounded to x's dtype
    first, f32 statistics, the output rounded to x's dtype."""
    dt = x.dtype
    mu, var = _stats(x.float())
    mul = torch.rsqrt(var + eps) * scale.to(dt).float()
    return ((x.float() - mu) * mul + bias.to(dt).float()).to(dt)


def _matmul(x, w, b):
    """nnx.Linear semantics: w (in, out) in x's dtype, f32 accumulation,
    the product rounded to x's dtype, then the bias added in x's dtype."""
    dt = x.dtype
    return (x.float() @ w.to(dt).float()).to(dt) + b.to(dt)


def _matmul_dx(g, w):
    """g @ w^T under the same policy (no bias)."""
    return (g.float() @ w.to(g.dtype).float().t()).to(g.dtype)


def _matmul_dw(x, g):
    """x^T @ g over all leading axes, in f32."""
    return x.float().reshape(-1, x.shape[-1]).t() @ g.float().reshape(-1, g.shape[-1])


def _layernorm_bwd(x, gamma, eps, dy):
    """VJP of :func:`_layernorm` at ``x``: (dx, dgamma, dbeta), the
    statistics recomputed alike; dgamma and dbeta summed over all leading
    axes in f32."""
    xf = x.float()
    mu, var = _stats(xf)
    rstd = torch.rsqrt(var + eps)
    xhat = (xf - mu) * rstd
    dyf = dy.float()
    c = x.shape[-1]
    dgamma = (dyf * xhat).reshape(-1, c).sum(dim=0)
    dbeta = dyf.reshape(-1, c).sum(dim=0)
    dxhat = dyf * gamma.to(x.dtype).float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype), dgamma, dbeta
