"""The port's RDNet and RDResUNet (pssr2_tpu_torch/models/rdnet.py,
rdresunet.py) and their weight carrying (pssr2_tpu_torch/weights.py)
against the JAX package, on the CPU, at a small size.

The JAX modules run their fused tail through the Pallas kernel in
interpret mode (``rdtail.MODE = "interpret"``); the port's through the
plain versions of ``ops/rdtail.py``.  Weights: the JAX modules' own, with
the LayerNorm and BatchNorm affines, the BatchNorm statistics and the
layer scales ``gamma`` redrawn from a seed (``gamma`` at its 1e-6 init
would scale every dense block's output to nothing), carried over by
``params_from_jax``.

Tolerances.  Modules (Block, DenseStage, RDNet), as fractions of the
largest output element: f32 1e-5 (the order of f32 sums); bf16 2 bf16
ulps (1/64), and 2/1000 on average.  The port's plain tail equals JAX's
``reference_tail`` in bf16 but for about one element in 6000
(tests/test_torch_rdtail.py), while JAX's interpreted kernel differs from
its own ``reference_tail`` by one bf16 ulp in about half the elements at
these widths (16 input channels: 52%, measured), so the JAX side sets the
bf16 bound here.  The whole model, on the [0, 255] output scale as
tests/test_torch_model.py states it: f32 2e-3; bf16 8 at most and 1 on
average.  The train step (f32): loss to 1e-5 relative, each gradient to
1e-3 of its largest element and all together to 1e-4 of their norm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pssr2_tpu.checkpoint import _flatten_state, load_weights
from pssr2_tpu.models import RDResUNet as JaxRDResUNet
from pssr2_tpu.models import rdnet as jrdnet
from pssr2_tpu.ops.pallas import rdtail as jrdtail
from pssr2_tpu.torch_import import export_torch_state_dict
from pssr2_tpu_torch.models import RDResUNet
from pssr2_tpu_torch.models import rdnet
from pssr2_tpu_torch.weights import params_from_jax, seeded_rdresunet_params

torch.set_num_threads(2)

# tests/test_rdtail.py's RDResUNet, at the port's x4
RD = dict(hidden=[32, 24], rdnet_init=16, growth_rates=(8, 8), ds_blocks=(False, True), ese_blocks=(False, True),
          n_blocks=2, scale=4)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jrdtail.MODE
    jrdtail.MODE = "interpret"
    yield
    jrdtail.MODE = old


def _jdt(dtype):
    return jnp.bfloat16 if dtype == "bf16" else None


def _tdt(dtype):
    return torch.bfloat16 if dtype == "bf16" else None


def _randomize(module, tmp_path, seed=0):
    """Redraw the JAX module's norms and layer scales from ``seed``; -> its
    flat weights."""
    flat = _flatten_state(nnx.state(module, nnx.Not(nnx.RngState)))
    rng = np.random.default_rng(seed)
    for key, value in flat.items():
        if key.endswith("gamma"):
            flat[key] = rng.uniform(0.5, 1.0, value.shape).astype(np.float32)
        elif "norm" in key and key.endswith(("/scale", "/var")):
            flat[key] = rng.uniform(0.8, 1.2, value.shape).astype(np.float32)
        elif "norm" in key and key.endswith(("/bias", "/mean")):
            flat[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
    path = tmp_path / f"weights_{seed}.npz"
    np.savez(path, **flat)
    load_weights(module, str(path))
    return flat


def _port_state(flat, jax_prefix, torch_prefix):
    """The port's state_dict of a submodule: its JAX keys placed at
    ``jax_prefix`` in an RDResUNet, mapped, and ``torch_prefix`` cut off."""
    state = params_from_jax({jax_prefix + k: v for k, v in flat.items()})
    assert all(k.startswith(torch_prefix) for k in state)
    return {k[len(torch_prefix):]: v for k, v in state.items()}


def _close(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max())
    err = np.abs(got - ref)
    if dtype == "f32":
        assert err.max() <= 1e-5 * scale, (err.max(), scale)
    else:
        assert err.max() <= scale / 64 and err.mean() <= 2e-3 * scale, (err.max(), err.mean(), scale)


def _x(shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, _jdt(dtype) or jnp.float32), torch.from_numpy(x).to(_tdt(dtype) or torch.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ese", [False, True], ids=["plain", "ese"])
def test_block_matches_jax(tmp_path, ese, dtype):
    c, inter, g = 24, 96, 16
    jblock = jrdnet.Block(c, inter, g, ese=ese, rngs=nnx.Rngs(0), dtype=_jdt(dtype))
    flat = _randomize(jblock, tmp_path)
    block = rdnet.Block(c, inter, g, ese=ese, device="cpu")
    block.load_state_dict(
        _port_state(flat, "encoder/stages/1/blocks/0/layers/", "encoder.dense_stages.1.2.dense_block0.layers."),
        strict=True,
    )
    xj, xt = _x((2, 8, 8, c), dtype)
    with torch.inference_mode():
        out = block(xt)
    assert out.dtype == xt.dtype and out.shape == (2, 8, 8, g)
    _close(out.float(), jblock(xj), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_stage_matches_jax(tmp_path, dtype):
    jstage = jrdnet.DenseStage(2, 16, 8, [0.0, 0.0], True, 4, 1e-6, rngs=nnx.Rngs(0), dtype=_jdt(dtype))
    flat = _randomize(jstage, tmp_path)
    stage = rdnet.DenseStage(2, 16, 8, [0.0, 0.0], True, 4, 1e-6, device="cpu")
    stage.load_state_dict(_port_state(flat, "encoder/stages/1/", "encoder.dense_stages.1.2."), strict=True)
    assert stage.num_out_features == jstage.num_out_features == 32
    xj, xt = _x((2, 8, 8, 16), dtype)
    with torch.inference_mode():
        out = stage(xt)
    _close(out.float(), jstage(xj), dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rdnet_matches_jax(tmp_path, dtype):
    kw = dict(in_channels=1, n_init_features=16, patch_size=2, growth_rates=(8, 8, 8),
              ds_blocks=(False, True, True), ese_blocks=(False, True, True), n_blocks=2)
    jnet = jrdnet.RDNet(**kw, rngs=nnx.Rngs(0), dtype=_jdt(dtype))
    flat = _randomize(jnet, tmp_path)
    net = rdnet.RDNet(**kw, device="cpu")
    net.load_state_dict(_port_state(flat, "encoder/", "encoder."), strict=True)
    assert net.feature_info == jnet.feature_info
    xj, xt = _x((2, 32, 32, 1), dtype)
    with torch.inference_mode():
        outs = net(xt)
    refs = jnet(xj)
    assert len(outs) == len(refs) == 3
    for out, ref in zip(outs, refs):
        _close(out.float(), ref, dtype)


def _models(tmp_path, dtype, seed=0):
    jmodel = JaxRDResUNet(**RD, dtype=_jdt(dtype), rngs=nnx.Rngs(0))
    flat = _randomize(jmodel, tmp_path, seed)
    model = RDResUNet(**RD, dtype=_tdt(dtype), device="cpu")
    model.load_state_dict(params_from_jax(flat), strict=True)
    return jmodel, model, flat


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rdresunet_matches_jax(tmp_path, dtype):
    jmodel, model, _ = _models(tmp_path, dtype)
    jmodel.eval()
    assert model.skips == jmodel.skips and model.ratios == jmodel.ratios
    x = np.random.default_rng(2).uniform(0, 255, (2, 1, 16, 16)).astype(np.float32)
    ref = np.asarray(jmodel(jnp.asarray(x)), np.float32)
    with torch.inference_mode():
        out = model(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 1, 64, 64) and out.dtype == np.float32
    diff = np.abs(out - ref)
    if dtype == "f32":
        assert diff.max() <= 2e-3, diff.max()
    else:
        assert diff.max() <= 8 and diff.mean() <= 1, (diff.max(), diff.mean())


def test_rdresunet_train_step_matches_jax(tmp_path):
    """Train mode (batch-statistics BatchNorms), f32: the loss of one
    forward and every parameter's gradient against nnx.grad of the same
    loss through the JAX model."""
    jmodel, model, _ = _models(tmp_path, "f32")
    rng = np.random.default_rng(3)
    lr = rng.uniform(0, 255, (2, 1, 16, 16)).astype(np.float32)
    hr = rng.uniform(0, 255, (2, 1, 64, 64)).astype(np.float32)
    jmodel.train()
    loss_j, grads = nnx.value_and_grad(lambda m: jnp.mean(((m(jnp.asarray(lr)) - hr) / 255.0) ** 2))(jmodel)
    grads_j = params_from_jax(_flatten_state(grads))
    model.train()
    loss = (((model(torch.from_numpy(lr)) - torch.from_numpy(hr)) / 255.0) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * float(loss_j)
    params = dict(model.named_parameters())
    assert sorted(grads_j) == sorted(params)
    num = den = 0.0
    for name, p in params.items():
        ref = grads_j[name]
        if p.grad is None:  # the decoder's conv biases, under stop-gradient
            assert not ref.any(), name
            continue
        scale = ref.abs().max().item()
        assert (p.grad - ref).abs().max().item() <= 1e-3 * scale, name
        num += float((p.grad - ref).double().square().sum())
        den += float(ref.double().square().sum())
    assert num**0.5 <= 1e-4 * den**0.5


def test_params_from_jax_equals_export(tmp_path):
    jmodel, _, flat = _models(tmp_path, "f32")
    ours = params_from_jax(flat)
    theirs = export_torch_state_dict(jmodel)
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)


def test_seeded_rdresunet_params_fit_both_packages(tmp_path):
    """The seeded weights that drive the port on the card have the JAX
    model's flat keys and shapes, load into both packages strictly, and
    give every dense block a layer scale in [0.5, 1]."""
    flat = seeded_rdresunet_params(**RD, seed=4)
    jmodel = JaxRDResUNet(**RD, rngs=nnx.Rngs(0))
    ref = _flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState)))
    assert {k: v.shape for k, v in flat.items()} == {k: v.shape for k, v in ref.items()}
    gammas = [v for k, v in flat.items() if k.endswith("gamma")]
    assert len(gammas) == 4 and all(0.5 <= g.min() and g.max() <= 1.0 for g in gammas)
    np.savez(tmp_path / "seeded.npz", **flat)
    load_weights(jmodel, str(tmp_path / "seeded.npz"))
    RDResUNet(**RD, device="cpu").load_state_dict(params_from_jax(flat), strict=True)


def test_full_width_layout():
    """The default RDResUNet: the JAX package's skips, decoder widths and
    parameter count (115,744,923), without building the JAX model."""
    model = RDResUNet(device="cpu")
    assert model.skips == [1040, 744, 472, 320]
    assert [b.conv[0].in_channels for b in model.decoder] == [1040, 1000, 728, 448]
    assert sum(p.numel() for p in model.parameters()) == 115_744_923
    assert {k: tuple(v.shape) for k, v in params_from_jax(seeded_rdresunet_params()).items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
    }


def test_drop_path():
    """Identity at rate 0 and in eval mode; in train mode whole samples are
    zeroed and the rest scaled by 1/(1 - rate)."""
    x = torch.rand(400, 3, 4, 5) + 0.5
    assert rdnet.DropPath(0.0).train()(x) is x
    dp = rdnet.DropPath(0.25, generator=torch.Generator().manual_seed(0))
    assert dp.eval()(x) is x
    y = dp.train()(x)
    kept = (y != 0).flatten(1)
    assert (kept.all(dim=1) | ~kept.any(dim=1)).all()  # all of a sample or none of it
    k = kept.all(dim=1)
    torch.testing.assert_close(y[k], x[k] / 0.75, rtol=0, atol=0)
    assert abs(k.float().mean().item() - 0.75) < 0.07  # 400 Bernoulli(0.75) draws: sd 0.022


def test_rdresunet_refuses_unported_variants():
    with pytest.raises(NotImplementedError):
        RDResUNet(**RD, dilations=[[1], [1]], device="cpu")
    with pytest.raises(NotImplementedError):
        RDResUNet(**RD, pool_sizes=[1, 2, 4, 8], device="cpu")
    with pytest.raises(NotImplementedError):
        RDResUNet(**RD, encoder_pool=True, device="cpu")
    with pytest.raises(ValueError, match="downsampling blocks"):
        RDResUNet(**dict(RD, hidden=[32, 24, 16]), device="cpu")
    with pytest.raises(KeyError, match="SwinIR"):
        params_from_jax({"encoder_pool/convs/0/kernel": np.zeros((1, 1, 8, 8), np.float32)})
