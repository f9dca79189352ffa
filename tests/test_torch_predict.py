"""The slice end to end: the port's ``predict_images`` against the JAX
package's, and the port standing alone.

``predict_images`` runs on both packages over the same tiles, with the
same weights and the same Poisson noise (``np.random`` seeded alike, one
loader thread).  Outputs are uint8 after a clip and a truncation, so an
f32 difference of order 1e-5 can still move a pixel across an integer:
they must differ by at most 1.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pssr2_tpu.crappifiers import Poisson as JaxPoisson
from pssr2_tpu.data import tiff as jtiff
from pssr2_tpu.data.datasets import ImageDataset as JaxImageDataset
from pssr2_tpu.models import ResUNet as JaxResUNet
from pssr2_tpu.predict import predict_images as jax_predict_images
from pssr2_tpu_torch import Poisson
from pssr2_tpu_torch.data import ImageDataset
from pssr2_tpu_torch.models import ResUNet
from pssr2_tpu_torch.predict import predict_images
from pssr2_tpu_torch.weights import params_from_jax

torch.set_num_threads(2)

HIDDEN, DEPTH = [8, 16], 1


def test_predict_images_matches_jax(tmp_path):
    from flax import nnx

    from pssr2_tpu.checkpoint import _flatten_state

    root = tmp_path / "imgs"
    root.mkdir()
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:64, 0:64]
    for i in range(5):
        img = 127 + 100 * np.sin(xx / (3 + i)) * np.cos(yy / (4 + i)) + rng.normal(0, 8, (64, 64))
        jtiff.imwrite(root / f"tile_{i}.tif", np.clip(img, 0, 255).astype(np.uint8))

    jmodel = JaxResUNet(hidden=HIDDEN, depth=DEPTH)
    model = ResUNet(hidden=HIDDEN, depth=DEPTH, device="cpu")
    model.load_state_dict(params_from_jax(_flatten_state(nnx.state(jmodel, nnx.Not(nnx.RngState)))))

    kwargs = dict(hr_res=64, lr_scale=4, val_split=1)
    np.random.seed(3)
    ours = predict_images(
        model, ImageDataset(root, crappifier=Poisson(), **kwargs), device="cpu",
        batch_size=2, out_dir=None, dataloader_kwargs={"num_workers": 1},
    )
    np.random.seed(3)
    theirs = jax_predict_images(
        jmodel, JaxImageDataset(root, crappifier=JaxPoisson(), **kwargs),
        batch_size=2, out_dir=None, dataloader_kwargs={"num_workers": 1},
    )
    assert sorted(ours) == sorted(theirs) == [f"tile_{i}" for i in range(5)]
    for name, ref in theirs.items():
        assert ours[name].dtype == np.uint8 and ours[name].shape == ref.shape == (1, 64, 64)
        assert np.abs(ours[name].astype(int) - ref.astype(int)).max() <= 1, name

    # the same run, written as .tif files named as the JAX package names them
    np.random.seed(3)
    out_dir = tmp_path / "preds"
    predict_images(
        model, ImageDataset(root, crappifier=Poisson(), **kwargs), device="cpu",
        batch_size=2, out_dir=str(out_dir), prefix="p", dataloader_kwargs={"num_workers": 1},
    )
    for name, image in ours.items():
        np.testing.assert_array_equal(jtiff.imread(out_dir / f"p_{name}.tif"), image[0])


_STANDALONE = """
import sys
from pathlib import Path
sys.modules["jax"] = None  # any import of JAX fails
import importlib, pkgutil
import numpy, scipy, torch  # what these load themselves (torch loads tqdm when present) is theirs
before = set(sys.modules)
import pssr2_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pssr2_tpu_torch.__path__, "pssr2_tpu_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(
    m for m in set(sys.modules) - before
    if m.split(".")[0] in ("pssr2_tpu", "jax", "flax", "tqdm", "PIL") and sys.modules[m] is not None
)
assert not leaked, leaked
print(" ".join(names))
"""


def test_port_imports_standalone():
    """Every module of the port imports with JAX made unimportable, and
    loads nothing of pssr2_tpu, flax, tqdm or PIL beyond what torch itself
    loads."""
    proc = subprocess.run(
        [sys.executable, "-c", _STANDALONE], capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parents[1],
    )
    assert proc.returncode == 0, proc.stderr
    names = proc.stdout.split()
    assert len(names) >= 21
    assert {"pssr2_tpu_torch.models.rdresunet", "pssr2_tpu_torch.models.rdnet", "pssr2_tpu_torch.ops.rdtail",
            "pssr2_tpu_torch.models.swinir", "pssr2_tpu_torch.ops.swinblock", "pssr2_tpu_torch.ops.winattn",
            "pssr2_tpu_torch.ops.blockmath"} <= set(names)


def test_entry_points_refuse_missing_card(tmp_path):
    """Without device="cpu" the entry points want the card, and raise where
    there is none; they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the entry points would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        ResUNet(hidden=HIDDEN, depth=DEPTH)
    model = ResUNet(hidden=HIDDEN, depth=DEPTH, device="cpu")
    root = tmp_path / "imgs"
    root.mkdir()
    jtiff.imwrite(root / "a.tif", np.zeros((64, 64), np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        predict_images(model, ImageDataset(root, hr_res=64, val_split=1), out_dir=None)


def test_build_key_follows_included_headers(tmp_path):
    """cuda_build.digest keys a build by the source and the csrc headers it
    includes: editing the shared header changes the key of both sources
    that include it, and the sources in the package do include it."""
    from pssr2_tpu_torch.ops import cuda_build

    for name in ("rdtail", "swinblock"):
        assert '#include "blockmath.cuh"' in (cuda_build.CSRC / f"{name}.cu").read_text()
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// v1\n")
    src = tmp_path / "k.cu"
    src.write_text('#include "shared.cuh"\n#include <cuda_runtime.h>\n')
    before = cuda_build.digest(src)
    (tmp_path / "other.cuh").write_text("// v2\n")
    assert cuda_build.digest(src) == before
    (tmp_path / "shared.cuh").write_text("// v2\n")
    assert cuda_build.digest(src) != before
