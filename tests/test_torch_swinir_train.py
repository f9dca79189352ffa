"""The port's SwinIR in training (pssr2_tpu_torch/models/swinir.py) against
the JAX package's, on the CPU: one train-mode loss and its gradients,
DropPath, the routing between the whole-block chain, the window-attention
path and the plain path, and ``use_checkpoint``.

The train step runs at full width (embed 96, 6 heads, 8 x 8 windows) and
small depth with ``weights.seeded_swinir_params``; the JAX model takes its
train chain through the interpreted whole-block VJP kernel.  Tolerances are
JAX's own (tests/test_swinblock.py:test_full_model_train_step_fused_
matches_unfused): the loss within 1e-3 relative, every gradient within 1e-4
of its largest element plus 2e-3 of itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from pssr2_tpu.checkpoint import _flatten_state
from pssr2_tpu.ops.pallas import swinblock as jswinblock
from pssr2_tpu_torch.models import SwinIR
from pssr2_tpu_torch.models import swinir
from pssr2_tpu_torch.ops import swinblock, winattn
from pssr2_tpu_torch.weights import params_from_jax
from test_torch_swinir import SMALL, _models

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _interpret_mode():
    old = jswinblock.MODE
    jswinblock.MODE = "interpret"
    yield
    jswinblock.MODE = old


def _train_step_close(jmodel, model, lr, hr):
    """One train-mode MSE loss and every parameter's gradient, the port's
    against nnx.grad of JAX's, within the module docstring's bounds."""
    jmodel.train()
    loss_j, grads = nnx.value_and_grad(lambda m: jnp.mean(((m(jnp.asarray(lr)) - hr) / 255.0) ** 2))(jmodel)
    grads_j = params_from_jax(_flatten_state(grads))
    model.train()
    loss = (((model(torch.from_numpy(lr)) - torch.from_numpy(hr)) / 255.0) ** 2).mean()
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-3 * max(1.0, float(loss_j))
    params = dict(model.named_parameters())
    assert sorted(grads_j) == sorted(params)
    for name, p in params.items():
        ref = grads_j[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=max(1e-4 * np.abs(ref).max(), 1e-7), rtol=2e-3,
                                   err_msg=name)


def test_swinir_train_step_matches_jax(tmp_path):
    """Train mode with drop path off, f32: the loss of one forward and every
    parameter's gradient against nnx.grad through JAX's train chain (the
    interpreted whole-block VJP kernel)."""
    jmodel, model, _ = _models(tmp_path, SMALL, "f32", drop_path_rate=0.0)
    rng = np.random.default_rng(3)
    lr = rng.uniform(0, 255, (1, 1, 32, 32)).astype(np.float32)
    hr = rng.uniform(0, 255, (1, 1, 128, 128)).astype(np.float32)
    _train_step_close(jmodel, model, lr, hr)


def test_drop_path_law():
    """DropPathTok: per-sample keep masks from the model's generator, scales
    {0, 1 / keep} at the rate's frequency, None in eval and at rate 0; the
    whole-block chain's scale pair and the per-block path's two masks come
    from the same draws, in the same order."""
    dp = swinir.DropPathTok(0.25, generator=torch.Generator().manual_seed(0)).train()
    s1, s2 = dp.scales(400, "cpu")
    s = torch.cat([s1, s2])
    assert set(s.unique().tolist()) <= {0.0, torch.tensor(1 / 0.75).item()}
    assert abs((s > 0).float().mean().item() - 0.75) < 0.05  # 800 Bernoulli(0.75) draws: sd 0.015
    again = swinir.DropPathTok(0.25, generator=torch.Generator().manual_seed(0)).train()
    keep1, keep2 = again.draw(400), again.draw(400)
    torch.testing.assert_close(s, torch.cat([keep1, keep2]).float() / 0.75, rtol=0, atol=0)
    x = torch.rand(400, 3, 5) + 0.5
    y = again(x, keep1)
    torch.testing.assert_close(y[keep1], x[keep1] / 0.75, rtol=0, atol=0)
    assert not y[~keep1].any()
    assert dp.eval().scales(4, "cpu") is None and dp.draw(4) is None
    assert swinir.DropPathTok(0.0).train().draw(4) is None


class _Spy:
    """Counts the calls of a module function while wrapping it."""

    def __init__(self, monkeypatch, module, name):
        self.n, fn = 0, getattr(module, name)

        def wrapped(*a, **k):
            self.n += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


def test_routing(monkeypatch):
    """Within MAX_C the whole-block chain in eval and in train (its plain
    forward and VJP on the CPU, one per block); past MAX_C (SwinIR-L's
    width, C 240 with 8 heads) the window-attention path in eval and the
    plain path in training, neither of them reaching the block's plain
    versions."""
    block = _Spy(monkeypatch, swinblock, "reference_block")
    block_bwd = _Spy(monkeypatch, swinblock, "reference_block_bwd")
    attn = _Spy(monkeypatch, winattn, "reference_window_attention_2d")
    x = torch.rand(1, 1, 16, 16) * 255
    narrow = SwinIR(image_size=16, depths=[2], num_heads=[6], device="cpu")
    with torch.no_grad():
        narrow(x)
    assert (block.n, block_bwd.n, attn.n) == (2, 0, 0)
    narrow.train()(x).mean().backward()
    assert (block.n, block_bwd.n, attn.n) == (4, 2, 0)
    assert swinblock.MAX_C < 240
    wide = SwinIR(image_size=16, embed_dim=240, depths=[2], num_heads=[8], device="cpu")
    with torch.no_grad():
        wide(x)
    assert (block.n, block_bwd.n, attn.n) == (4, 2, 2)
    wide.train()(x).mean().backward()
    assert (block.n, block_bwd.n, attn.n) == (4, 2, 2)


def test_use_checkpoint_gives_the_same_gradients():
    """use_checkpoint on the per-block training path (SwinIR-L's width),
    with drop path live: the masks are drawn outside the recomputed
    blocks, so the gradients are the same bit for bit."""
    x = torch.rand(2, 1, 16, 16) * 255
    grads = []
    for ckpt in (False, True):
        torch.manual_seed(0)
        model = SwinIR(image_size=16, embed_dim=240, depths=[2], num_heads=[8], drop_path_rate=0.5,
                       use_checkpoint=ckpt, device="cpu", generator=torch.Generator().manual_seed(5)).train()
        model(x).square().mean().backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=0, msg=name)
