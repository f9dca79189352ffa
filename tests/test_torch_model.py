"""The port's ResUNet (pssr2_tpu_torch/models) and weight carrying
(pssr2_tpu_torch/weights.py) against the JAX package, at a small size.

Weights: the JAX model's flat parameters and batch stats (the content of a
``checkpoint.save_weights`` file), with BatchNorm statistics drawn from a
seed so that every BatchNorm does work, go through ``params_from_jax``
and must equal ``torch_import.export_torch_state_dict`` key for key.

Model tolerances, on the [0, 255] output scale: f32 agrees to 2e-3 (f32
rounding through ~10 layers, scaled by 128).  bf16 rounds activations to
8 bits after every layer, and the two packages round in different places
(the port rounds the BatchNorm affine once, as the TPU kernel chain does;
the JAX CPU path rounds scale and bias first; its reconstruction head is
the TPU form), so bf16 agrees to 8 output units at most and 1 on average,
where one bf16 ulp of the last conv's output is 1 unit at mid-range.
"""

import numpy as np
import pytest
import torch
from flax import nnx

from pssr2_tpu.checkpoint import _flatten_state, load_weights, save_weights
from pssr2_tpu.models import ResUNet as JaxResUNet
from pssr2_tpu.torch_import import export_torch_state_dict
from pssr2_tpu_torch.models import ResUNet
from pssr2_tpu_torch.weights import load_jax_weights, params_from_jax, seeded_jax_params

torch.set_num_threads(2)

HIDDEN, DEPTH = [8, 16, 32], 1


def _jax_model(tmp_path, dtype=None, seed=0):
    """A small JAX ResUNet with seeded BatchNorm statistics, saved and
    reloaded through a ``.npz`` like a trained checkpoint."""
    import jax.numpy as jnp

    model = JaxResUNet(hidden=HIDDEN, depth=DEPTH, dtype=jnp.bfloat16 if dtype == "bf16" else None)
    flat = _flatten_state(nnx.state(model, nnx.Not(nnx.RngState)))
    rng = np.random.default_rng(seed)
    for key, value in flat.items():
        if key.endswith(("/mean", "/bias")) and "norm" in key:
            flat[key] = rng.normal(0, 0.2, value.shape).astype(np.float32)
        elif key.endswith(("/var", "/scale")):
            flat[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
    path = tmp_path / "weights.npz"
    np.savez(path, **flat)
    load_weights(model, str(path))
    model.eval()
    return model, flat, path


def test_params_from_jax_equals_export(tmp_path):
    model, flat, _ = _jax_model(tmp_path)
    ours = params_from_jax(flat)
    theirs = export_torch_state_dict(model)
    assert list(sorted(ours)) == list(sorted(theirs))
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_npz_loads_strictly(tmp_path):
    model, _, _ = _jax_model(tmp_path)
    path = tmp_path / "saved.npz"
    save_weights(model, path)
    port = ResUNet(hidden=HIDDEN, depth=DEPTH, device="cpu")
    load_jax_weights(port, path)
    with np.load(path) as flat:
        np.testing.assert_array_equal(
            port.encoder[1].conv[3].weight.detach().numpy(),
            np.transpose(flat["encoder/1/convs/1/kernel"], (3, 2, 0, 1)),
        )
    assert set(port.state_dict()) == set(params_from_jax(np.load(path)))


def test_unported_variant_is_refused():
    with pytest.raises(NotImplementedError):
        ResUNet(hidden=HIDDEN, depth=DEPTH, dilations=[[1], [1], [1]], device="cpu")
    with pytest.raises(KeyError):
        params_from_jax({"encoder/0/branches/0/0/1/kernel": np.zeros((3, 3, 1, 8), np.float32)})


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_resunet_matches_jax(tmp_path, dtype):
    model, _, path = _jax_model(tmp_path, dtype=dtype, seed=1)
    port = ResUNet(
        hidden=HIDDEN, depth=DEPTH, dtype=torch.bfloat16 if dtype == "bf16" else None, device="cpu"
    )
    load_jax_weights(port, path)

    x = np.random.default_rng(2).uniform(0, 255, (2, 1, 32, 32)).astype(np.float32)
    ref = np.asarray(model(x), np.float32)
    with torch.inference_mode():
        out = port(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 1, 128, 128) and out.dtype == np.float32
    diff = np.abs(out - ref)
    if dtype == "f32":
        assert diff.max() <= 2e-3, diff.max()
    else:
        assert diff.max() <= 8 and diff.mean() <= 1, (diff.max(), diff.mean())


def test_seeded_jax_params_fit_both_packages(tmp_path):
    """The seeded init that drives the port on the card has exactly the JAX
    model's flat keys and shapes, and loads into both packages strictly."""
    flat = seeded_jax_params(hidden=HIDDEN, depth=DEPTH, seed=4)
    model, ref, _ = _jax_model(tmp_path)
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}
    np.savez(tmp_path / "seeded.npz", **flat)
    load_weights(model, str(tmp_path / "seeded.npz"))
    load_jax_weights(ResUNet(hidden=HIDDEN, depth=DEPTH, device="cpu"), tmp_path / "seeded.npz")
