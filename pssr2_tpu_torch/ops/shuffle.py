"""Pixel shuffle (depth-to-space) on channels-last tensors
(counterpart: pssr2_tpu/ops/shuffle.py:12)."""

import torch


def pixel_shuffle(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(N, H, W, C*r^2) -> (N, H*r, W*r, C), with the input channels read
    as (C, r, r) in row-major order, as ``torch.pixel_shuffle`` reads them."""
    r = scale
    if r == 1:
        return x
    n, h, w, c = x.shape
    nc = c // (r * r)
    x = x.reshape(n, h, w, nc, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, h * r, w * r, nc)
