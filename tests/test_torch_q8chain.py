"""The port's int8 conv layer (pssr2_tpu_torch/ops/q8chain.py) on the CPU,
against the JAX package:

- the plain layer against JAX's oracle ``reference_q8_layer`` and against
  the Pallas kernel ``q8_conv_layer`` interpreted (``MODE="interpret"``,
  packed layouts included), both epilogues.  Bit for bit against the
  oracle: the int32 sums are exact on both sides and the f32 affine rounds
  its multiply and its add alike.  The interpreted kernel contracts the
  affine into a fused multiply-add (JAX's own test allows it 1e-5
  relative): its int8 outputs are held bit for bit, its glue outputs to
  1e-6 of the largest (measured: one f32 ulp in a quarter of them);
- the per-conv int8 sites (``_qconv``: quantize, int8 conv, affine, glue
  out) against JAX's, bit for bit: the entry conv (Cin 1), a residual 1x1
  and the reconstruction's pre-conv (Cin 33, no multiple of 4), f32 and
  bf16 glue;
- a mid-chain requantization equals ``quantize_tensor`` of the ReLU of the
  dequantized output (the scheme the folded affine computes);
- the kernel's packed weight layout.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu import quant as jquant
from pssr2_tpu.ops.pallas import convchain as jconvchain
from pssr2_tpu.ops.pallas import q8chain as jq8chain
from pssr2_tpu_torch import quant
from pssr2_tpu_torch.ops import q8chain

# the glue outputs against the interpreted Pallas kernel, relative to the largest
PALLAS_GLUE_TOL = 1e-6


@pytest.fixture
def interpret_mode():
    old = jq8chain.MODE
    jq8chain.MODE = "interpret"
    yield
    jq8chain.MODE = old


def _inputs(seed, h, w, cin, cout, k=3):
    rng = np.random.default_rng(seed)
    x8 = rng.integers(-127, 128, (2, h, w, cin)).astype(np.int8)
    k8 = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)  # HWIO, as JAX keeps it
    affine = np.stack([rng.uniform(1e-4, 1e-2, cout), rng.normal(0, 0.5, cout)]).astype(np.float32)
    return x8, k8, affine


def _w8(k8):
    return torch.from_numpy(np.ascontiguousarray(k8.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("h,w", [(6, 128), (10, 64), (8, 32)])
@pytest.mark.parametrize("last", [False, True], ids=["mid", "glue"])
def test_plain_layer_matches_jax(interpret_mode, h, w, last):
    x8, k8, affine = _inputs(h * w + last, h, w, 32, 32)
    got = q8chain.q8_conv_layer(torch.from_numpy(x8), _w8(k8), torch.from_numpy(affine), last=last,
                                out_dtype=torch.float32)
    assert got.shape == (2, h, w, 32) and got.dtype == (torch.float32 if last else torch.int8)
    got = got.numpy()
    xj = jnp.transpose(jnp.asarray(x8), (0, 1, 3, 2))  # JAX's (N, H, C, W) layer layout
    wmat8 = jconvchain.kernel_matrix(jnp.asarray(k8))
    ref = np.transpose(np.asarray(jq8chain.reference_q8_layer(xj, wmat8, jnp.asarray(affine), last=last,
                                                               out_dtype=jnp.float32)), (0, 1, 3, 2))
    p = 128 // min(w, 128)
    xp = jq8chain.pack_nhwc(jnp.asarray(x8), p) if p > 1 else xj
    yk = jq8chain.q8_conv_layer(xp, wmat8, jnp.asarray(affine), last=last, pack=p, out_dtype=jnp.float32)
    yk = jq8chain.unpack_nhwc(yk, p, w) if p > 1 else jnp.transpose(yk, (0, 1, 3, 2))
    np.testing.assert_array_equal(got, ref)
    if last:
        assert np.abs(got - np.asarray(yk)).max() <= PALLAS_GLUE_TOL * np.abs(ref).max()
    else:
        np.testing.assert_array_equal(got, np.asarray(yk))


def _entry(seed, cin, cout, k):
    """A per-conv site as JAX's quant builds it and the same for the port."""
    rng = np.random.default_rng(seed)
    _, k8, affine = _inputs(seed, 1, 1, cin, cout, k)
    inv_sx = np.float32(1.0) / np.float32(rng.uniform(0.01, 0.05))
    jentry = {"w8": jnp.asarray(k8), "alpha": jnp.asarray(affine[0]), "beta": jnp.asarray(affine[1]),
              "inv_sx": jnp.asarray(inv_sx)}
    entry = {"w8": _w8(k8), "alpha": torch.from_numpy(affine[0]), "beta": torch.from_numpy(affine[1]),
             "inv_sx": torch.tensor(inv_sx)}
    return jentry, quant._QConv(entry)


@pytest.mark.parametrize("glue", ["f32", "bf16"])
@pytest.mark.parametrize("cin,cout,k", [(1, 64, 3), (48, 32, 1), (33, 64, 3)], ids=["entry", "res1x1", "recon_pre"])
def test_per_conv_sites_match_jax(glue, cin, cout, k):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[glue]
    jentry, site = _entry(cin + cout + k, cin, cout, k)
    x = np.random.default_rng(k).normal(0, 1.5, (2, 12, 20, cin)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    ref = np.asarray(jquant._qconv(jentry, xj, jdt).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    got = site(xt, tdt)
    assert got.dtype == tdt and got.shape == (2, 12, 20, cout)
    np.testing.assert_array_equal(
        quant.quantize_tensor(xt, site.inv_sx).numpy(), np.asarray(jquant.quantize_tensor(xj, jentry["inv_sx"])))
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_mid_chain_requant_is_quantize_of_the_dequantized_relu():
    x8, k8, _ = _inputs(3, 6, 16, 32, 32)
    rng = np.random.default_rng(4)
    alpha = torch.from_numpy(rng.uniform(1e-4, 1e-3, 32).astype(np.float32))
    beta = torch.from_numpy(rng.normal(0, 0.2, 32).astype(np.float32))
    inv_next = torch.tensor(1.0 / 0.037, dtype=torch.float32)
    x8t, w8 = torch.from_numpy(x8), _w8(k8)
    y8 = q8chain.q8_conv_layer(x8t, w8, torch.stack([alpha * inv_next, beta * inv_next]))
    zf = q8chain.q8_conv_layer(x8t, w8, torch.stack([alpha, beta]), last=True, out_dtype=torch.float32)
    want = quant.quantize_tensor(torch.relu(zf), inv_next)
    # the two round at different places (alpha * inv_next, then the affine),
    # so a value within an ulp of a half may land on either side
    assert (y8.int() - want.int()).abs().max() <= 1 and (y8 != want).float().mean() < 1e-3


def test_kernel_weight_layout():
    w8 = torch.from_numpy(np.random.default_rng(0).integers(-127, 128, (5, 37, 3, 3)).astype(np.int8))
    wk = q8chain.kernel_weight(w8)
    assert wk.dtype == torch.int32 and wk.shape == (9, 64 // 4, 5)  # Cin 37 padded to the k-tile, 64
    b = wk.contiguous().view(torch.int8).view(9, 16, 5, 4)  # byte j of word i: channel 4i + j (little-endian)
    unpacked = b.permute(0, 1, 3, 2).reshape(9, 64, 5)
    assert torch.equal(unpacked[:, :37], w8.permute(2, 3, 1, 0).reshape(9, 37, 5))
    assert not unpacked[:, 37:].any()


def test_cpu_takes_the_plain_version():
    before = q8chain.launches
    x8, k8, affine = _inputs(0, 4, 4, 8, 8)
    q8chain.q8_conv_layer(torch.from_numpy(x8), _w8(k8), torch.from_numpy(affine))
    assert q8chain.launches == before
    with pytest.raises(TypeError):
        q8chain.q8_conv_layer(torch.from_numpy(x8), _w8(k8), torch.from_numpy(affine), out_dtype=torch.float16)
