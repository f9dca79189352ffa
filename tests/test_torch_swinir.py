"""The port's SwinIR (pssr2_tpu_torch/models/swinir.py) and its weight
carrying (pssr2_tpu_torch/weights.py) against the JAX package's SwinIR, on
the CPU, at full width (embed 96, 6 heads, 8 x 8 windows) and small depth:
eval and the weights here, training in tests/test_torch_swinir_train.py,
SwinIR-L's widths in tests/test_torch_swinir_wide.py.

Weights: ``weights.seeded_swinir_params`` (JAX's initialisers, LayerNorm
scales in [0.5, 1.5]) loaded into both packages.  The JAX model runs its
whole-block chain through the Pallas kernel in interpret mode
(``swinblock.MODE = "interpret"``) or its per-block XLA path (``"off"``);
the port runs its whole-block chain through the plain versions of
``ops/swinblock.py``.

Tolerances are JAX's own (tests/test_swinblock.py): eval f32 2e-4 and bf16
0.01 of the largest output (the fused-against-unfused bounds of
``test_full_model_chain_matches_unfused``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pssr2_tpu.checkpoint import load_weights
from pssr2_tpu.models.swinir import SwinIR as JaxSwinIR
from pssr2_tpu.ops.pallas import swinblock as jswinblock
from pssr2_tpu.torch_import import export_torch_state_dict, torch_key_map
from pssr2_tpu_torch.models import SwinIR
from pssr2_tpu_torch.weights import params_from_jax, seeded_swinir_params

torch.set_num_threads(2)

SMALL = dict(image_size=32, depths=[2, 2], num_heads=[6, 6])


@pytest.fixture(autouse=True)
def _restore_mode():
    old = jswinblock.MODE
    yield
    jswinblock.MODE = old


def _models(tmp_path, kw, dtype=None, seed=1, gain=1.0, **extra):
    """(JAX model, port model, flat weights) with the same seeded weights,
    the Swin blocks' linear kernels and bias tables times ``gain``."""
    flat = seeded_swinir_params(**kw, seed=seed)
    if gain != 1.0:
        flat = {k: v * np.float32(gain) if "/blocks/" in k and k.endswith(("kernel", "table")) else v
                for k, v in flat.items()}
    jmodel = JaxSwinIR(**kw, **extra, dtype=jnp.bfloat16 if dtype == "bf16" else None, rngs=nnx.Rngs(0))
    np.savez(tmp_path / "w.npz", **flat)
    load_weights(jmodel, str(tmp_path / "w.npz"))
    model = SwinIR(**kw, **extra, dtype=torch.bfloat16 if dtype == "bf16" else None, device="cpu")
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, model, flat


def _eval_close(jmodel, model, x, dtype):
    jmodel.eval()
    ref = np.asarray(jmodel(jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        out = model(torch.from_numpy(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    tol = 2e-4 * max(1.0, np.abs(ref).max()) if dtype == "f32" else 0.01 * np.abs(ref).max()
    np.testing.assert_allclose(out.numpy(), ref, atol=tol)


@pytest.mark.parametrize("size,mode,dtype", [(32, "interpret", "f32"), (32, "off", "f32"), (36, "interpret", "f32"),
                                             (36, "off", "f32"), (32, "interpret", "bf16"), (36, "off", "bf16")])
def test_swinir_eval_matches_jax(tmp_path, size, mode, dtype):
    """Eval on 32^2 and on 36^2, which the model reflect-pads to 40^2 and
    crops back, against JAX's whole-block chain and its per-block path."""
    jswinblock.MODE = mode
    jmodel, model, _ = _models(tmp_path, SMALL, dtype)
    x = np.random.default_rng(size).uniform(0, 255, (1, 1, size, size)).astype(np.float32)
    _eval_close(jmodel, model, x, dtype)


HEADS = {
    "pixelshuffledirect": dict(upsampler="pixelshuffledirect"),
    "nearest+conv_3conv_ape": dict(upsampler="nearest+conv", resi_connection="3conv", ape=True),
    "nearest+conv_x2": dict(upsampler="nearest+conv", scale=2),
    "residual": dict(upsampler=""),
    "pixelshuffle_x3": dict(scale=3),
    "window_clamp": dict(image_size=4),
}


@pytest.mark.parametrize("head", list(HEADS))
def test_swinir_heads_match_jax(tmp_path, head):
    """Each upsampler head, '3conv', ``ape`` and the window clamp
    (``image_size`` <= ws: the blocks take 4 x 4 windows and no shift, on
    the 4 x 4 input reflect-padded to 8 x 8), f32, against JAX's model."""
    jswinblock.MODE = "interpret"
    kw = dict(dict(image_size=16, depths=[1], num_heads=[6]), **HEADS[head])
    jmodel, model, _ = _models(tmp_path, kw, "f32")
    if head == "window_clamp":
        blk = model.layers[0].residual_group.blocks[0]
        assert (blk.window_size, blk.shift_size) == (4, 0)
    size = min(kw["image_size"], 16)
    x = np.random.default_rng(3).uniform(0, 255, (2, 1, size, size)).astype(np.float32)
    _eval_close(jmodel, model, x, "f32")


def test_params_from_jax_equals_export(tmp_path):
    """params_from_jax of a '3conv', ape, nearest+conv SwinIR equals the JAX
    package's reference-named export, key by key."""
    kw = dict(image_size=16, depths=[1, 1], num_heads=[6, 6], upsampler="nearest+conv", resi_connection="3conv",
              ape=True)
    jmodel, _, flat = _models(tmp_path, kw)
    ours = params_from_jax(flat)
    theirs = export_torch_state_dict(jmodel)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_full_width_layout():
    """The default SwinIR(): the JAX model's parameter count (1,986,049) and
    reference .pth key layout and shapes, both models abstract (the meta
    device and nnx.eval_shape), and the seeded weights' keys and shapes."""
    jmodel = nnx.eval_shape(lambda: JaxSwinIR(rngs=nnx.Rngs(0)))
    n_jax = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(nnx.state(jmodel, nnx.Param)))
    model = SwinIR(device="meta")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 1_986_049
    assert sorted(torch_key_map(jmodel)) == sorted(model.state_dict())
    assert {k: tuple(v.shape) for k, v in params_from_jax(seeded_swinir_params()).items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }
    assert [len(layer.residual_group.blocks) for layer in model.layers] == [4, 4, 4, 4]
    assert [blk.shift_size for blk in model.layers[0].residual_group.blocks] == [0, 4, 0, 4]


def test_swinir_refuses_bad_arguments():
    with pytest.raises(ValueError, match="Lengths"):
        SwinIR(depths=[2, 2], num_heads=[6], device="cpu")
    with pytest.raises(ValueError, match="patch_size"):
        SwinIR(patch_size=2, device="cpu")
    with pytest.raises(ValueError, match="resi_connection"):
        SwinIR(depths=[1], num_heads=[6], resi_connection="2conv", device="cpu")
    with pytest.raises(ValueError, match="scale"):
        SwinIR(depths=[1], num_heads=[6], scale=5, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SwinIR(depths=[1], num_heads=[6])
