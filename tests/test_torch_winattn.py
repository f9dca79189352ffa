"""The port's window attention (pssr2_tpu_torch/ops/winattn.py) against the
JAX package's (pssr2_tpu/ops/pallas/winattn.py), on the CPU.

The plain versions (reached through ``fused_window_attention`` and
``fused_window_attention_2d``, which take them for CPU tensors) are held
against JAX's ``reference_window_attention(_2d)`` and against its Pallas
kernels run with ``interpret=True``, masked (the shift mask of a 16 x 16
image, two images of windows) and unmasked, in f32 and bf16; the gradient
(the port recomputes through its plain version, as JAX's custom VJP does
through its reference) against ``jax.vjp``.

Tolerances.  f32: 2e-5 (tests/test_winattn.py's).  bf16: against the
interpreted kernel, whose rounding the port follows (f32 scores, f32
softmax, the probabilities rounded to bf16), one bf16 ulp of the largest
output (1/128); against the XLA reference, whose scores and softmax are
bf16, 0.03 of the largest: JAX's own interpreted kernel differs from that
reference by 0.0213 of the largest output on the unmasked inputs here
(measured), above the 0.02 of tests/test_swinblock.py's bf16 bound.
Gradients (f32): rtol and atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.models.swinir import _shift_attn_mask as jax_shift_attn_mask
from pssr2_tpu.ops.pallas import winattn as jwinattn
from pssr2_tpu_torch.ops import winattn

torch.set_num_threads(2)

HEADS, D, WS = 2, 8, 8
N, C = WS * WS, HEADS * D
SCALE = D**-0.5
SPEC = (16, 16, WS, WS // 2)


def _inputs(seed, images=2):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((images, 16, 16, 3 * C)).astype(np.float32)
    bias = (rng.standard_normal((HEADS, N, N)) * 0.1).astype(np.float32)
    return qkv, bias


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bf16" else jnp.float32


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bf16" else torch.float32


def _check(got, fused, ref, dtype):
    got = got.float().numpy()
    fused, ref = np.asarray(fused, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, fused, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        scale = np.abs(ref).max()
        assert np.abs(got - fused).max() <= scale / 128
        assert np.abs(got - ref).max() <= 0.03 * scale


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_windows_layout_matches_jax(masked, dtype):
    """(W, n, 3C) windows: the 1-D functions."""
    qkv_img, bias = _inputs(1 + masked)
    qkv = winattn.windows(torch.from_numpy(qkv_img), WS).numpy()
    spec = SPEC if masked else None
    mask = None if spec is None else jax_shift_attn_mask(*spec)
    qj = jnp.asarray(qkv, _jdt(dtype))
    fused = jwinattn.fused_window_attention(qj, jnp.asarray(bias), spec, SCALE, HEADS, interpret=True)
    ref = jwinattn.reference_window_attention(qj, jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
                                              SCALE, HEADS)
    got = winattn.fused_window_attention(torch.from_numpy(qkv).to(_tdt(dtype)), torch.from_numpy(bias), spec,
                                         SCALE, HEADS)
    assert got.dtype == _tdt(dtype)
    _check(got, fused, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "masked"])
def test_image_layout_matches_jax(masked, dtype):
    """(B, H, W, 3C) images: the 2-D functions."""
    qkv, bias = _inputs(3 + masked)
    spec = SPEC if masked else None
    mask = None if spec is None else jax_shift_attn_mask(*spec)
    qj = jnp.asarray(qkv, _jdt(dtype))
    fused = jwinattn.fused_window_attention_2d(qj, jnp.asarray(bias), spec, SCALE, HEADS, WS, interpret=True)
    ref = jwinattn.reference_window_attention_2d(qj, jnp.asarray(bias), None if mask is None else jnp.asarray(mask),
                                                 SCALE, HEADS, WS)
    got = winattn.fused_window_attention_2d(torch.from_numpy(qkv).to(_tdt(dtype)), torch.from_numpy(bias), spec,
                                            SCALE, HEADS, WS)
    _check(got, fused, ref, dtype)


@pytest.mark.parametrize("layout", ["windows", "image"])
def test_gradient_matches_jax_vjp(layout):
    """d(qkv) and d(bias) of a masked attention against jax.vjp of JAX's
    interpreted kernel (its custom VJP recomputes through the reference)."""
    qkv, bias = _inputs(7)
    rng = np.random.default_rng(8)
    if layout == "windows":
        qkv = winattn.windows(torch.from_numpy(qkv), WS).numpy()
        jfn = lambda a, b: jwinattn.fused_window_attention(a, b, SPEC, SCALE, HEADS, interpret=True)
        tfn = lambda a, b: winattn.fused_window_attention(a, b, SPEC, SCALE, HEADS)
    else:
        jfn = lambda a, b: jwinattn.fused_window_attention_2d(a, b, SPEC, SCALE, HEADS, WS, interpret=True)
        tfn = lambda a, b: winattn.fused_window_attention_2d(a, b, SPEC, SCALE, HEADS, WS)
    out, vjp = jax.vjp(jfn, jnp.asarray(qkv), jnp.asarray(bias))
    g = rng.standard_normal(out.shape).astype(np.float32)
    gq, gb = vjp(jnp.asarray(g))
    qt, bt = torch.from_numpy(qkv).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    tfn(qt, bt).backward(torch.from_numpy(g))
    np.testing.assert_allclose(qt.grad.numpy(), np.asarray(gq), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb), rtol=1e-5, atol=1e-5)


def test_mask_of_a_multi_image_batch():
    """Window w takes mask[w % nW]: a batch of two images equals each image
    alone."""
    qkv, bias = _inputs(9)
    q, b = torch.from_numpy(qkv), torch.from_numpy(bias)
    both = winattn.fused_window_attention_2d(q, b, SPEC, SCALE, HEADS, WS)
    for i in range(2):
        one = winattn.fused_window_attention_2d(q[i : i + 1], b, SPEC, SCALE, HEADS, WS)
        torch.testing.assert_close(both[i : i + 1], one, rtol=0, atol=0)
