"""2x2/stride-2 max pooling on channels-last tensors
(counterpart: pssr2_tpu/ops/pooling.py:25)."""

import torch


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, C), max over each 2x2 window (odd
    sizes floor, as torch's MaxPool2d(2) does)."""
    n, h, w, c = x.shape
    x = x[:, : h - h % 2, : w - w % 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
