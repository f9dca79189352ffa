"""The port's SwinIR past the whole-block kernel's MAX_C against the JAX
package's, on the CPU: SwinIR-L's widths (embed 240, 8 heads, '3conv',
'nearest+conv') on the per-block paths, in eval (the whole model and block
by block, f32 and bf16) and in training (one loss and its gradients,
f32).  Eval compares with JAX's per-block path through its window-attention
kernel interpreted, as JAX runs it in eval on the TPU; training with JAX's
per-block XLA path, as JAX trains.  Bounds are JAX's own, those of
tests/test_torch_swinir.py and tests/test_torch_swinir_train.py.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pssr2_tpu.ops.pallas import swinblock as jswinblock
from pssr2_tpu.ops.pallas import winattn as jwinattn
from pssr2_tpu_torch.ops import swinblock, winattn
from test_torch_swinir import _eval_close, _models
from test_torch_swinir_train import _train_step_close

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _restore_mode():
    old = jswinblock.MODE
    yield
    jswinblock.MODE = old


# SwinIR-L's widths (C 240 past the whole-block kernel's MAX_C, 8 heads,
# '3conv', 'nearest+conv') at one layer of two blocks, the second shifted.
# At JAX's init (std 0.02) the scores are near 0, so each window's
# attention is near its mean and the branches are small beside the
# shortcut: a misplaced window or token would hide inside the bounds.  The
# blocks' kernels and bias tables times WIDE_GAIN make the scores O(1-10).
WIDE = dict(image_size=16, embed_dim=240, depths=[2], num_heads=[8], resi_connection="3conv",
            upsampler="nearest+conv")
WIDE_GAIN = 10.0


@pytest.fixture
def per_block_path(monkeypatch):
    """Both models on their per-block eval path.  JAX: its whole-block
    chain off, and its window-attention kernel (interpreted) taken as on the
    TPU (the gate that keeps it off the CPU, ``eligible_2d``, forced true),
    so that both sides compute the kernel's f32 scores and max-subtracted
    softmax.  The port: its whole-block versions made unusable, and the
    window attention's plain version counted."""
    jswinblock.MODE = "off"
    monkeypatch.setattr(jwinattn, "eligible_2d", lambda *a, **k: True)
    calls = {"jax": 0, "port": 0}

    def counted(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(jwinattn, "fused_window_attention_2d",
                        counted("jax", functools.partial(jwinattn.fused_window_attention_2d, interpret=True)))
    monkeypatch.setattr(winattn, "reference_window_attention_2d",
                        counted("port", winattn.reference_window_attention_2d))
    monkeypatch.setattr(swinblock, "reference_block", None)
    return calls


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swinir_wide_eval_matches_jax(tmp_path, per_block_path, dtype):
    """Eval past MAX_C, the whole model: the port's per-block path (plain
    LayerNorm and linears, the roll, the window-attention core's plain
    version, the residuals and the MLP) with '3conv' and 'nearest+conv'
    against JAX's per-block XLA path, in f32 and bf16, on a 16^2 input (2 x
    2 windows, so the shifted block is masked)."""
    jmodel, model, _ = _models(tmp_path, WIDE, dtype, gain=WIDE_GAIN)
    x = np.random.default_rng(7).uniform(0, 255, (2, 1, 16, 16)).astype(np.float32)
    _eval_close(jmodel, model, x, dtype)
    assert per_block_path == {"jax": 2, "port": 2}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_swinir_wide_blocks_match_jax(tmp_path, per_block_path, dtype):
    """Eval past MAX_C, block by block (shift 0, then 4 and masked): each
    SwinTransformerBlock of the port against JAX's on the same unit-normal
    (2, 16 * 16, 240) tokens in the compute dtype, where the block's
    branches are as large as its shortcut; bounds of
    test_swinir_eval_matches_jax."""
    jmodel, model, _ = _models(tmp_path, WIDE, dtype, gain=WIDE_GAIN)
    jmodel.eval()
    x = np.random.default_rng(8).standard_normal((2, 16 * 16, 240)).astype(np.float32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    pairs = list(zip(jmodel.layers[0].residual_group.blocks, model.layers[0].residual_group.blocks))
    assert [blk.shift_size for _, blk in pairs] == [0, 4]
    for jblk, blk in pairs:
        ref = np.asarray(jblk(jnp.asarray(x, jdt), (16, 16)), np.float32)
        with torch.inference_mode():
            out = blk(torch.from_numpy(x).to(tdt), (16, 16)).float().numpy()
        tol = 2e-4 * max(1.0, np.abs(ref).max()) if dtype == "f32" else 0.01 * np.abs(ref).max()
        assert np.abs(ref - x).max() > np.abs(x).max()  # the branches outweigh the shortcut
        np.testing.assert_allclose(out, ref, atol=tol, err_msg=f"shift {blk.shift_size}")
    assert per_block_path == {"jax": 2, "port": 2}


def test_swinir_wide_train_step_matches_jax(tmp_path, monkeypatch):
    """Train mode past MAX_C (WIDE, WIDE_GAIN), drop path off, f32: the
    port's plain per-block path under autograd against nnx.grad through
    JAX's per-block XLA path, with the bounds of
    test_torch_swinir_train.test_swinir_train_step_matches_jax."""
    jswinblock.MODE = "off"
    monkeypatch.setattr(swinblock, "reference_block", None)  # the whole-block chain must not run
    jmodel, model, _ = _models(tmp_path, WIDE, "f32", gain=WIDE_GAIN, drop_path_rate=0.0)
    rng = np.random.default_rng(4)
    lr = rng.uniform(0, 255, (2, 1, 16, 16)).astype(np.float32)
    hr = rng.uniform(0, 255, (2, 1, 64, 64)).astype(np.float32)
    _train_step_close(jmodel, model, lr, hr)
