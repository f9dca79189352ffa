"""PIL-BILINEAR-matched resize, on the host and on the device
(counterpart: pssr2_tpu/ops/resize.py:20-85).  PIL's bilinear downscale is
an antialiased triangle filter whose support grows with the downscale
ratio; the weights below mirror PIL's ``precompute_coeffs``."""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """PIL-compatible triangle-filter weight matrix of shape (in_size, out_size)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale

    weights = np.zeros((in_size, out_size), dtype=np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size)
        ww = 0.0
        ws = np.zeros(xmax - xmin)
        for x in range(xmin, xmax):
            w = (x + 0.5 - center) / filterscale
            w = 1.0 - abs(w) if abs(w) < 1.0 else 0.0
            ws[x - xmin] = w
            ww += w
        if ww != 0:
            ws /= ww
        weights[xmin:xmax, i] = ws
    return weights.astype(np.float32)


def resize_bilinear_np(image: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Resize the trailing two dims of ``image`` (float32 out):
    ``out[..., i, j] = sum_{h,w} image[..., h, w] * Wh[h, i] * Ww[w, j]``."""
    in_h, in_w = image.shape[-2], image.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return image.astype(np.float32)
    wh = _resize_weights(in_h, out_h)
    ww = _resize_weights(in_w, out_w)
    # optimize=True contracts pairwise (the naive einsum is O(H*W*out_h*out_w))
    return np.einsum("...hw,hi,wj->...ij", image.astype(np.float32), wh, ww, optimize=True)


@functools.lru_cache(maxsize=16)
def _weights_on(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights(in_size, out_size)).to(device)


def resize_bilinear(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """:func:`resize_bilinear_np` on a tensor, on its device: two f32
    matrix products, ``out[..., i, j] = sum_{h,w} image[..., h, w] *
    Wh[h, i] * Ww[w, j]`` (TF32 is off for the package)."""
    in_h, in_w = image.shape[-2], image.shape[-1]
    if (in_h, in_w) == (out_h, out_w):
        return image
    wh = _weights_on(in_h, out_h, image.device)
    ww = _weights_on(in_w, out_w, image.device)
    return torch.matmul(torch.matmul(wh.T, image.float()), ww)
