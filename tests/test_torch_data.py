"""The port's host data path (pssr2_tpu_torch/ops/resize.py, data/tiff.py,
data/io.py, data/datasets.py, crappifiers.py, util.py) against the JAX
package.  These are numpy on both sides, so everything is exact: the same
weights, the same bytes, the same items once both sides seed numpy's (and
Python's) global streams alike.
"""

import random

import numpy as np
import pytest
import torch

from pssr2_tpu import util as jutil
from pssr2_tpu.crappifiers import Poisson as JaxPoisson
from pssr2_tpu.data import tiff as jtiff
from pssr2_tpu.data.datasets import ImageDataset as JaxImageDataset
from pssr2_tpu.ops import resize as jresize
from pssr2_tpu_torch import util
from pssr2_tpu_torch.crappifiers import Poisson
from pssr2_tpu_torch.data import ImageDataset, tiff
from pssr2_tpu_torch.ops import resize

torch.set_num_threads(2)


@pytest.mark.parametrize("sizes", [(512, 128), (64, 16), (100, 37), (16, 64)])
def test_resize_weights_equal(sizes):
    np.testing.assert_array_equal(resize._resize_weights(*sizes), jresize._resize_weights(*sizes))
    image = np.random.default_rng(0).uniform(0, 255, (2, 1, sizes[0], sizes[0])).astype(np.float32)
    np.testing.assert_array_equal(
        resize.resize_bilinear_np(image, sizes[1], sizes[1]),
        jresize.resize_bilinear_np(image, sizes[1], sizes[1]),
    )


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("pages", [1, 3])
def test_tiff_round_trips_with_jax_codec(tmp_path, dtype, pages):
    rng = np.random.default_rng(pages)
    image = (rng.uniform(0, 200, (pages, 24, 40))).astype(dtype).squeeze()
    jtiff.imwrite(tmp_path / "jax.tif", image)
    np.testing.assert_array_equal(tiff.imread(tmp_path / "jax.tif"), image)
    tiff.imwrite(tmp_path / "port.tif", image)
    np.testing.assert_array_equal(jtiff.imread(tmp_path / "port.tif"), image)
    assert tiff.num_pages_and_size(tmp_path / "port.tif") == (pages, (24, 40))
    tiff.imwrite(tmp_path / "big.tif", image, bigtiff=True)
    np.testing.assert_array_equal(jtiff.imread(tmp_path / "big.tif"), image)


def _tifs(path, n, res, seed=0):
    path.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n):
        jtiff.imwrite(path / f"img_{i}.tif", rng.integers(0, 256, (res, res), dtype=np.uint8))
    return path


@pytest.mark.parametrize(
    "kwargs",
    [
        {"hr_res": 64, "val_split": 1},
        {"hr_res": 48, "val_split": 0.5, "crappifier": "poisson-spread"},
        {"hr_res": 64, "lr_scale": -1, "val_split": 1},
    ],
    ids=["val", "train-rotated", "lr-mode"],
)
def test_imagedataset_items_equal(tmp_path, kwargs):
    root = _tifs(tmp_path / "imgs", 4, 64)
    kw = dict(kwargs)
    spread = kw.pop("crappifier", None) == "poisson-spread"
    port = ImageDataset(root, crappifier=Poisson(spread=0.3) if spread else Poisson(), **kw)
    ref = JaxImageDataset(root, crappifier=JaxPoisson(spread=0.3) if spread else JaxPoisson(), **kw)
    assert len(port) == len(ref) and port.val_idx == ref.val_idx
    assert port.is_lr == ref.is_lr and port.crop_res == ref.crop_res
    for idx in range(len(port)):
        assert port._get_name(idx) == ref._get_name(idx)
        items = []
        for ds in (port, ref):
            np.random.seed(idx)
            random.seed(idx)
            items.append(ds[idx])
        a, b = items
        for x, y in zip(*(v if isinstance(v, tuple) else (v,) for v in (a, b))):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(x, y)


def test_normalize_preds_equal():
    rng = np.random.default_rng(0)
    hr = rng.integers(0, 256, (2, 1, 32, 32)).astype(np.uint8)
    hr_hat = rng.integers(0, 256, (2, 1, 32, 32)).astype(np.uint8)
    for a, b in zip(util.normalize_preds(hr, hr_hat), jutil.normalize_preds(hr, hr_hat)):
        np.testing.assert_array_equal(a, b)
    assert util.pixel_metric(0.01) == jutil.pixel_metric(0.01)
