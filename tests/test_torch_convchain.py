"""The port's convchain layer (pssr2_tpu_torch/ops/convchain.py) against
the JAX package: the Pallas kernel ``convchain.fused_conv_layer`` in
interpret mode, its ``reference_layer``, and the NHWC twins
``convnhwc.reference_layer_nhwc`` and ``fusedlayer.fused_layer_reference``.

On the CPU the port's wrapper takes its plain version, so these tests hold
the function the CUDA kernel must compute; tests/test_torch_cuda_kernels.py
holds the kernel against that plain version on the card.

Tolerances are those the kernel is held to against its plain version
(``pssr2_tpu_torch/ops/convchain.py:TOLERANCE``): in f32 only the order of
summation differs; in bf16 an output may differ by one bf16 ulp, since one
f32 ulp of difference can move its rounding and XLA's CPU backend computes
bf16 elementwise ops in f32 and may drop an intermediate rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.ops.pallas import convchain, convnhwc, fusedlayer
from pssr2_tpu_torch.ops import convchain as tconvchain

torch.set_num_threads(2)

N, H, W, COUT = 2, 6, 16, 8
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret_mode():
    old = convchain.MODE
    convchain.MODE = "interpret"
    yield
    convchain.MODE = old


def _inputs(seed, cin, bias=True):
    """NHWC x, HWIO kernel, bias, ab as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (N, H, W, cin)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, cin, COUT)).astype(np.float32)
    b = rng.normal(0, 0.1, (COUT,)).astype(np.float32) if bias else np.zeros(COUT, np.float32)
    ab = np.stack([rng.uniform(0.5, 1.5, cin), rng.normal(0, 0.3, cin)]).astype(np.float32)
    return x, k, b, ab


def _port(x, k, b, ab, tdt):
    """The port's wrapper on CPU tensors: (y NHWC, s1, s2)."""
    y, s1, s2 = tconvchain.fused_conv_layer(
        torch.from_numpy(x).to(tdt),
        torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()),
        torch.from_numpy(b),
        None if ab is None else torch.from_numpy(ab),
    )
    assert y.dtype == tdt and s1.dtype == s2.dtype == torch.float32
    return y, s1, s2


def _assert_close(port, ref):
    """``ref`` = JAX (y NHWC, s1, s2) arrays; held to convchain.TOLERANCE."""
    y = torch.tensor(np.asarray(ref[0], np.float32)).to(port[0].dtype)
    ref = (y, *(torch.tensor(np.asarray(s, np.float32)) for s in ref[1:]))
    assert port[0].shape == ref[0].shape
    for name, (err, _, bound) in tconvchain.errors(port, ref).items():
        assert err <= bound, f"{name}: max abs error {err} > {bound}"


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False])
@pytest.mark.parametrize("cin", [1, 8, 16])
def test_layer_matches_pallas_and_reference(interpret_mode, cin, relu_in, dtype_name):
    jdt, tdt = DTYPES[dtype_name]
    x, k, b, ab = _inputs(cin * 10 + relu_in, cin)
    port = _port(x, k, b, ab if relu_in else None, tdt)

    xt = jnp.asarray(np.transpose(x, (0, 1, 3, 2)), jdt)  # NHWC -> NHCW
    args = (xt, convchain.kernel_matrix(jnp.asarray(k)), jnp.asarray(b), jnp.asarray(ab) if relu_in else None)
    for fn in (convchain.fused_conv_layer, convchain.reference_layer):
        y, s1, s2 = fn(*args, relu_in=relu_in)
        y = np.transpose(np.asarray(y, np.float32), (0, 1, 3, 2))  # NHCW -> NHWC
        _assert_close(port, (y, s1, s2))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("relu_in", [True, False])
def test_layer_matches_nhwc_reference(dtype_name, relu_in):
    jdt, tdt = DTYPES[dtype_name]
    x, k, b, ab = _inputs(7 + relu_in, 16)
    port = _port(x, k, b, ab if relu_in else None, tdt)
    ref = convnhwc.reference_layer_nhwc(
        jnp.asarray(x, jdt), convnhwc.kernel_taps(jnp.asarray(k)), jnp.asarray(b),
        jnp.asarray(ab) if relu_in else None, relu_in=relu_in,
    )
    _assert_close(port, ref)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_layer_matches_fusedlayer_reference(dtype_name):
    """fusedlayer computes the same layer without a bias."""
    jdt, tdt = DTYPES[dtype_name]
    x, k, b, ab = _inputs(11, 8, bias=False)
    port = _port(x, k, b, ab, tdt)
    y, sums = fusedlayer.fused_layer_reference(
        jnp.asarray(x, jdt), jnp.asarray(k), jnp.asarray(ab[0]), jnp.asarray(ab[1])
    )
    _assert_close(port, (y, sums[0], sums[1]))


def test_cpu_tensor_takes_plain_version():
    """A CPU tensor goes to the plain version, which launches nothing and
    stays differentiable."""
    x, k, b, _ = _inputs(3, 8)
    w = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy()).requires_grad_()
    y, _, _ = tconvchain.fused_conv_layer(torch.from_numpy(x), w, torch.from_numpy(b))
    assert y.requires_grad
    assert tconvchain.launches == 0  # the plain version is no launch


def test_kernel_weight_layout():
    """The forward kernels' weight layouts are convnhwc's kernel_taps of the
    HWIO kernel: (9, Cin, Cout) for the f32 route; for the bf16 route
    (9, Cout, Cin_pad), K-major, Cin zero-padded to the K chunk."""
    _, k, _, _ = _inputs(5, 8)
    taps = np.asarray(convnhwc.kernel_taps(jnp.asarray(k)))
    weight = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy())
    np.testing.assert_array_equal(tconvchain.kernel_weight(weight, torch.float32).numpy(), taps)
    wk = tconvchain.kernel_weight(weight, torch.bfloat16)
    assert wk.shape == (9, COUT, tconvchain.K_CHUNK) and wk.dtype == torch.bfloat16 and wk.is_contiguous()
    want = torch.from_numpy(taps.transpose(0, 2, 1).copy()).to(torch.bfloat16)
    assert torch.equal(wk[:, :, :8], want)
    assert not wk[:, :, 8:].any()


def test_kernel_weight_dx_layout():
    """The dx kernels read kernel_taps with the taps flipped: the f32 one
    its own (9, Cout, Cin) layout; the bf16 one the forward's bf16 layout at
    tap 8 - t, as [Cout][Cin], with the Cin pad zero."""
    _, k, _, _ = _inputs(6, 8)
    flipped = np.asarray(convnhwc.kernel_taps(jnp.asarray(k)))[::-1]  # (9, Cin, Cout), tap 8 - t
    weight = torch.from_numpy(np.transpose(k, (3, 2, 0, 1)).copy())
    np.testing.assert_array_equal(tconvchain.kernel_weight_dx(weight).numpy(), flipped.transpose(0, 2, 1))
    wk = tconvchain.kernel_weight(weight, torch.bfloat16)
    read = wk.flip(0)  # what the bf16 dx kernel reads at tap t: wk[8 - t], [Cout][Cin_pad]
    want = torch.from_numpy(flipped.transpose(0, 2, 1).copy()).to(torch.bfloat16)
    assert torch.equal(read[:, :, :8], want) and not read[:, :, 8:].any()


# (n, h, w, Cin, Cout): ragged H and W, channel counts off the tiles, the
# model's small 8x8 grid at batch 16, and wide RDResUNet layers
PLAN_SHAPES = [(2, 9, 20, 40, 192), (1, 8, 8, 1, 64), (3, 13, 7, 200, 72), (16, 8, 8, 1024, 1024),
               (16, 16, 16, 1000, 1024), (16, 32, 32, 728, 512), (2, 17, 33, 24, 33)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tc_plan_covers_every_output_once(shape):
    """The bf16 forward and dx grids, read as the kernels read them, cover
    every (pixel, channel) of their output exactly once."""
    n, h, w, cin, cout = shape
    for nch in (cout, cin):  # the forward's N is Cout, dx's Cin
        wg, bn, (gx, gy) = tconvchain.tc_plan(n, h, w, nch)
        assert wg in (1, 2) and bn in (64, 128) and gy <= 65535
        count = np.zeros((n, h, w, nch), np.uint8)
        for bx in range(gx):
            for i in range(wg):
                t = bx * wg + i
                if t >= tconvchain.sub_tiles(n, h, w):
                    continue
                img, h0, w0 = tconvchain.sub_tile_origin(t, n, h, w)
                for by in range(gy):
                    count[img, h0:h0 + tconvchain.TILE, w0:w0 + tconvchain.TILE, by * bn:by * bn + bn] += 1
        assert (count == 1).all()


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_tc_dw_plan_covers_every_term_once(shape):
    """The bf16 dW grid sums every (tap, Cin, Cout) entry over every pixel
    exactly once: its blocks split the channels and the sub-tiles without
    gaps or overlaps (each block takes all 9 taps)."""
    n, h, w, cin, cout = shape
    gx, gy, splits = tconvchain.tc_dw_plan(n, h, w, cin, cout)
    n_sub = tconvchain.sub_tiles(n, h, w)
    assert gy <= 65535 and 1 <= splits <= min(n_sub, 65535)
    # a block covers its Cin rows x its Cout columns x its sub-tiles: the
    # grid covers each term once iff each factor does
    rows = np.zeros(cin, np.int64)
    for bx in range(gx):
        rows[64 * bx:64 * bx + 64] += 1
    cols = np.zeros(cout, np.int64)
    for by in range(gy):
        cols[64 * by:64 * by + 64] += 1
    subs = np.zeros(n_sub, np.int64)
    for bz in range(splits):
        subs[bz::splits] += 1
    assert (rows == 1).all() and (cols == 1).all() and (subs == 1).all()
    # and the sub-tiles tile the image: each pixel in exactly one
    cover = np.zeros((n, h, w), np.int64)
    for t in range(n_sub):
        img, h0, w0 = tconvchain.sub_tile_origin(t, n, h, w)
        cover[img, h0:h0 + tconvchain.TILE, w0:w0 + tconvchain.TILE] += 1
    assert (cover == 1).all()
