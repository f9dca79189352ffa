"""The port's W8A8 serving quantization (pssr2_tpu_torch/quant.py) on the
CPU, against the JAX package's (pssr2_tpu/quant.py), on the same weights
and calibration batches:

- ``quantize_resunet`` and ``quantize_rdresunet``: every site's int8
  weights equal JAX's (the reconstruction's pre-conv after undoing JAX's
  phase-major channel order), the affines and ``inv_sx`` within 1e-5
  relative (of the largest element of a site's beta, where ``bias * a +
  c`` cancels): the calibration's max-abs comes from each package's own
  float forward, which agree to about 1e-6;
- the executors' outputs, f32 and bf16 glue: with JAX's own scales
  (alpha, beta, inv_sx) loaded into the port's executor, against JAX's
  executor run op by op with its chain kernel interpreted
  (``q8chain.MODE = "interpret"``, at shapes where JAX's gate chains the
  same layers as the port: 32-aligned channels, lane-packable images); and
  as calibrated by each package, against JAX's default jitted per-conv
  engine (``"off"``) within JAX's own 5e-3 relative L2 bound between the
  two;
- ``calibrate_from_dataset`` against JAX's; the eval-mode, model-type and
  ResUNetA / PSP guards; ``predict_images`` serving a quantized executor.

Tolerances, relative L2 over the output ([0, 255] scale).  An int8 value
that lands on the other side of a rounding boundary moves the output by
a quantization step, so each tolerance follows from what can flip one:
- ResUNet f32 with JAX's scales, 1e-6: the int8 layers agree bit for bit
  and only the reconstruction's float conv sums in another order
  (measured 4.5e-8);
- RDResUNet f32, 1e-3: its float RDNet encoder differs from JAX's by f32
  rounding (about 1e-6), which flips a few decoder int8 values (measured
  1.9e-4);
- bf16 glue, 3e-3: PyTorch and XLA round bf16 glue at different places
  (measured 2.5e-4 and 1.3e-3; the int8 executor is 0.9e-3 and 1.4e-3 from
  the float model);
- jitted JAX, 5e-3: XLA's fusions contract the affines into fused
  multiply-adds, which flips int8 values too (measured up to 1.4e-3).
"""

import copy
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pssr2_tpu import quant as jquant
from pssr2_tpu.checkpoint import _flatten_state, load_weights
from pssr2_tpu.data import ImageDataset as JaxImageDataset
from pssr2_tpu.data import tiff as jtiff
from pssr2_tpu.models import RDResUNet as JaxRDResUNet
from pssr2_tpu.models import ResUNet as JaxResUNet
from pssr2_tpu.ops.pallas import q8chain as jq8chain
from pssr2_tpu.ops.smallconv import phase_major_perm
from pssr2_tpu_torch import quant
from pssr2_tpu_torch.data import ImageDataset
from pssr2_tpu_torch.models import RDResUNet, ResUNet
from pssr2_tpu_torch.predict import predict_images
from pssr2_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

HIDDEN, DEPTH, SCALE = [32, 64], 1, 2
RD = dict(hidden=[32, 24], rdnet_init=16, growth_rates=(8, 8), ds_blocks=(False, True), ese_blocks=(False, True),
          n_blocks=2, scale=2)
AFFINE_RTOL = 1e-5
CHAIN_TOL = {("ResUNet", "f32"): 1e-6, ("RDResUNet", "f32"): 1e-3, ("ResUNet", "bf16"): 3e-3,
             ("RDResUNet", "bf16"): 3e-3}
PER_CONV_TOL = 5e-3


def _randomize(module, tmp_path, seed=0):
    """Redraw the JAX module's norms (and RDNet's layer scales) from
    ``seed``, so that every BatchNorm folds a real affine; -> flat weights."""
    flat = _flatten_state(nnx.state(module, nnx.Not(nnx.RngState)))
    rng = np.random.default_rng(seed)
    for key, value in flat.items():
        if key.endswith("gamma"):
            flat[key] = rng.uniform(0.5, 1.0, value.shape).astype(np.float32)
        elif "norm" in key and key.endswith(("/scale", "/var")):
            flat[key] = rng.uniform(0.6, 1.4, value.shape).astype(np.float32)
        elif "norm" in key and key.endswith(("/bias", "/mean")):
            flat[key] = rng.normal(0, 0.2, value.shape).astype(np.float32)
    path = tmp_path / f"weights_{seed}.npz"
    np.savez(path, **flat)
    load_weights(module, str(path))
    return flat


def _batches(n=2, b=2, res=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((b, 1, res, res)) * 255).astype(np.float32) for _ in range(n)]


def _models(tmp_path, kind, dtype):
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    if kind == "ResUNet":
        jmodel = JaxResUNet(hidden=HIDDEN, depth=DEPTH, scale=SCALE, dtype=jdt, rngs=nnx.Rngs(0))
        model = ResUNet(hidden=HIDDEN, depth=DEPTH, scale=SCALE, dtype=tdt, device="cpu")
    else:
        jmodel = JaxRDResUNet(**RD, dtype=jdt, rngs=nnx.Rngs(0))
        model = RDResUNet(**RD, dtype=tdt, device="cpu")
    model.load_state_dict(params_from_jax(_randomize(jmodel, tmp_path)), strict=True)
    jmodel.eval()
    return jmodel, model.eval()


@pytest.fixture(scope="module")
def quantized(tmp_path_factory):
    """{(kind, dtype): (JAX executor, port executor, port float model)}."""
    out = {}
    for kind, res in (("ResUNet", 32), ("RDResUNet", 64)):
        for dtype in ("f32", "bf16"):
            jmodel, model = _models(tmp_path_factory.mktemp(f"{kind}_{dtype}"), kind, dtype)
            calib = _batches(res=res)
            jfn, fn = (jquant.quantize_resunet, quant.quantize_resunet) if kind == "ResUNet" else \
                (jquant.quantize_rdresunet, quant.quantize_rdresunet)
            out[kind, dtype] = (jfn(jmodel, calib), fn(model, calib), model)
    return out


def _qblocks(q):
    return (list(q.encoder) if isinstance(q, quant.QuantizedResUNet) else []) + list(q.decoder)


def _sites(q):
    """{JAX site name: port _QConv} of a port executor."""
    sites = {"recon": q.recon.pre}
    blocks = {"dec": q.decoder}
    if isinstance(q, quant.QuantizedResUNet):
        blocks["enc"] = q.encoder
    for prefix, blks in blocks.items():
        for idx, blk in enumerate(blks):
            sites[f"{prefix}{idx}.res"] = blk.res
            for i, conv in enumerate(blk.convs):
                sites[f"{prefix}{idx}.c{i}"] = conv
    return sites


@pytest.mark.parametrize("kind", ["ResUNet", "RDResUNet"])
def test_quantized_sites_match_jax(quantized, kind):
    jq, q, model = quantized[kind, "f32"]
    sites = _sites(q)
    assert set(sites) == {k for k in jq.params if k.endswith(tuple(f".c{i}" for i in range(9)) + (".res",))} | {"recon"}
    for name, site in sites.items():
        je = jq.params[name]
        w8 = np.asarray(je["w8"]).transpose(3, 2, 0, 1)
        alpha, beta = site.alpha.numpy(), site.beta.numpy()
        if name == "recon":
            perm = phase_major_perm(model.reconstruction.conv.in_channels, SCALE)
            alpha, beta, got = alpha[perm], beta[perm], site.w8.numpy()[perm]
            np.testing.assert_array_equal(q.recon.post_weight.numpy(), np.asarray(je["post_kernel"]).transpose(3, 2, 0, 1))
        else:
            got = site.w8.numpy()
        np.testing.assert_array_equal(got, w8, err_msg=name)
        for ours, theirs in ((alpha, je["alpha"]), (beta, je["beta"]), (site.inv_sx.numpy(), je["inv_sx"])):
            theirs = np.asarray(theirs)
            np.testing.assert_allclose(ours, theirs, rtol=AFFINE_RTOL, atol=AFFINE_RTOL * np.abs(theirs).max(),
                                       err_msg=name)
    if kind == "ResUNet":
        np.testing.assert_allclose(q.norm_a.numpy(), np.asarray(jq.params["norm.a"]), rtol=1e-6)
        np.testing.assert_allclose(q.norm_c.numpy(), np.asarray(jq.params["norm.c"]), rtol=1e-6, atol=1e-7)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _with_jax_scales(q, jq, model):
    """A copy of the port's executor with JAX's alpha, beta and inv_sx (and
    the input norm's affine) in every site, the chain affines refolded."""
    q = copy.deepcopy(q)
    perm = phase_major_perm(model.reconstruction.conv.in_channels, SCALE)
    with torch.no_grad():
        for name, site in _sites(q).items():
            je = jq.params[name]
            for key in ("alpha", "beta", "inv_sx"):
                value = torch.from_numpy(np.array(je[key]))
                if name == "recon" and key != "inv_sx":
                    getattr(site, key)[perm] = value
                else:
                    getattr(site, key).copy_(value)
        for blk in _qblocks(q):
            convs = list(blk.convs) + [blk.res]
            for i, conv in enumerate(convs):
                scale = convs[i + 1].inv_sx if conv.mid else 1.0
                conv.affine.copy_(torch.stack([conv.alpha * scale, conv.beta * scale]))
        q.recon.pre.affine.copy_(torch.stack([q.recon.pre.alpha, q.recon.pre.beta]))
        if isinstance(q, quant.QuantizedResUNet):
            q.norm_a.copy_(torch.from_numpy(np.array(jq.params["norm.a"])))
            q.norm_c.copy_(torch.from_numpy(np.array(jq.params["norm.c"])))
    return q


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["ResUNet", "RDResUNet"])
def test_quantized_outputs_match_jax(quantized, kind, dtype):
    jq, q, model = quantized[kind, dtype]
    res = 32 if kind == "ResUNet" else 64
    x = _batches(n=1, res=res, seed=7)[0]
    with torch.inference_mode():
        out = q(torch.from_numpy(x)).numpy()
        fp = model(torch.from_numpy(x)).numpy()
    assert out.shape == (2, 1, res * SCALE, res * SCALE) and out.dtype == np.float32 and np.isfinite(out).all()
    # the executor is int8 (not the float model) and close to it
    assert 0 < _rel_l2(out, fp) < 0.05

    old = jq8chain.MODE
    calls = []
    orig = jq8chain.q8_conv_layer
    try:
        jq8chain.MODE = "interpret"
        jq8chain.q8_conv_layer = lambda *a, **k: (calls.append(a[0].shape), orig(*a, **k))[1]
        with jax.disable_jit():  # op by op: XLA's fusions round otherwise
            chained = np.asarray(jq.apply(jq.params, jnp.asarray(x)), np.float32)
        jq8chain.q8_conv_layer = orig
        jq8chain.MODE = "off"
        per_conv = np.asarray(type(jq)(jq.params, jq._meta)(jnp.asarray(x)), np.float32)
    finally:
        jq8chain.q8_conv_layer = orig
        jq8chain.MODE = old
    # JAX chained exactly the layers the port chains
    assert len(calls) == sum(len(b.convs) - b.split for b in _qblocks(q)) > 0
    with torch.inference_mode():
        same_scales = _with_jax_scales(q, jq, model)(torch.from_numpy(x)).numpy()
    assert _rel_l2(same_scales, chained) <= CHAIN_TOL[kind, dtype]
    assert _rel_l2(out, per_conv) <= PER_CONV_TOL


def _dataset_files(root, n=6, res=32):
    rng = np.random.default_rng(4)
    root.mkdir()
    for i in range(n):
        jtiff.imwrite(root / f"{i}.tif", rng.integers(0, 255, (res, res)).astype(np.uint8))
    return root


def test_calibrate_from_dataset_matches_jax(tmp_path):
    root = _dataset_files(tmp_path / "imgs")
    for val_split in (0.5, 1):
        kwargs = dict(hr_res=32, lr_scale=2, val_split=val_split, crappifier=None, rotation=False)
        ours = quant.calibrate_from_dataset(ImageDataset(root, **kwargs), n_batches=2, batch_size=2)
        theirs = jquant.calibrate_from_dataset(JaxImageDataset(root, **kwargs), n_batches=2, batch_size=2)
        assert len(ours) == len(theirs) >= 1
        for a, b in zip(ours, theirs):
            assert a.shape[1:] == (1, 16, 16)
            np.testing.assert_array_equal(a, b)


def test_guards():
    model = ResUNet(hidden=[8, 16], depth=1, device="cpu")
    with pytest.raises(ValueError, match="calib"):
        quant.quantize_resunet(model, [])
    with pytest.raises(ValueError, match="eval"):
        quant.quantize_resunet(model.train(), _batches(res=16))
    with pytest.raises(NotImplementedError, match="ResUNet"):
        quant.quantize_resunet(RDResUNet(**RD, device="cpu"), _batches())
    with pytest.raises(NotImplementedError, match="RDResUNet"):
        quant.quantize_rdresunet(model.eval(), _batches())
    with pytest.raises(ValueError, match="eval"):
        quant.quantize_rdresunet(RDResUNet(**RD, device="cpu").train(), _batches())
    # a block that is not a plain ResBlock (ResUNetA's ResBlockA, PSP pooling)
    model.encoder[0] = torch.nn.Identity()
    with pytest.raises(NotImplementedError, match="queue 1 item 3"):
        quant.quantize_resunet(model.eval(), _batches(res=16))


def test_executor_is_eval_only_and_moves_as_a_module(quantized):
    _, q, _ = quantized["ResUNet", "f32"]
    assert not q.train().training and all(not m.training for m in q.modules())
    buffers = dict(q.named_buffers())
    assert buffers["encoder.1.convs.0.w8"].dtype == torch.int8 and "recon.pre.affine" in buffers
    assert q.to("cpu") is q


def test_predict_images_serves_a_quantized_executor(quantized, tmp_path):
    from pssr2_tpu_torch.data import tiff

    _, q, _ = quantized["ResUNet", "f32"]
    root = _dataset_files(tmp_path / "lr", n=3, res=32)
    random.seed(0)
    dataset = ImageDataset(root, hr_res=32 * SCALE, lr_scale=SCALE, val_split=1)
    assert dataset.is_lr
    predict_images(q, dataset, device="cpu", batch_size=2, out_dir=str(tmp_path / "preds"))
    preds = sorted((tmp_path / "preds").glob("*.tif"))
    assert len(preds) == 3
    for p in preds:
        image = tiff.imread(p)
        assert image.shape == (32 * SCALE, 32 * SCALE) and image.dtype == np.uint8
