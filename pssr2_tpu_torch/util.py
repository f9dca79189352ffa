"""Utilities: the losses, prediction normalization, the pixel and PSNR
metrics and the callback protocol (counterpart: pssr2_tpu/util.py:19-180, 301-411;
reference: pssr/util.py)."""

import inspect
import math

import numpy as np
import torch

from .ops import ssimfused
from .ops.resize import resize_bilinear_np
from .ops.ssim import _MS_WEIGHTS, _blur_same, ms_ssim, ssim


class MSELoss:
    """Mean-squared-error loss with a per-sample variant (torch MSELoss parity)."""

    def __call__(self, input, target):
        return torch.mean((input - target) ** 2)

    def per_sample(self, input, target):
        return torch.mean((input - target) ** 2, dim=tuple(range(1, input.dim())))


class SSIMLoss:
    def __init__(self, channels: int = 1, mix: float = 0.8, win_size: int = 11, win_sigma: float = 1.5,
                 ms: bool = True, kwargs=None, dtype=None):
        """SSIM and MS-SSIM loss with Mix as detailed in Zhao et al., 2018
        (reference: pssr/util.py:10-52): ``mix * (1 - (MS-)SSIM) + (1 - mix)
        * windowed L1``.

        Args:
            channels (int) : Number of channels in image. Default is 1.

            mix (float) : Mix of SSIM loss in loss calculation. 1 is entirely
                SSIM, 0 is entirely L1 with Gaussian correction. Default is 0.8.

            win_size (int) : Size of Gaussian window. Must be odd. Default is 11.

            win_sigma (float) : Sigma of the Gaussian window. Default is 1.5.

            ms (bool) : Use MS-SSIM over basic SSIM. Default is True.

            kwargs : Extra kwargs forwarded to the ssim implementation.

            dtype : Optional compute dtype for the loss (e.g.
                ``torch.bfloat16``).  The default (None) keeps float32,
                matching pytorch_msssim numerics; other dtypes take the
                band-matrix path, not the kernels.  The variance terms
                (``E[x^2] - E[x]^2``) cancel badly in 8-bit mantissas, and
                a canonical training under a bf16 loss diverged in the JAX
                package: not for training.
        """
        self.channels = channels
        self.win_size = win_size
        self.win_sigma = win_sigma
        self.ms = ms
        self.mix = mix
        self.kwargs = {} if kwargs is None else kwargs
        self.dtype = dtype

    def _ssim_val(self, input, target, size_average):
        fn = ms_ssim if self.ms else ssim
        return fn(
            input,
            target,
            data_range=1,
            win_size=self.win_size,
            win_sigma=self.win_sigma,
            size_average=size_average,
            **self.kwargs,
        )

    def _l1_windowed(self, input, target, per_sample):
        # Gaussian-windowed L1: the window over the unreduced L1 map with
        # zero padding, per channel (reference util.py:48-51)
        out = _blur_same(torch.abs(input - target), self.win_size, self.win_sigma)
        if per_sample:
            return out.mean(dim=tuple(range(1, out.dim())))
        return out.mean()

    def _cast(self, input, target):
        if self.dtype is not None:
            return input.to(self.dtype), target.to(self.dtype)
        return input, target

    def _fused_mix_loss(self, input, target, divisor, size_average):
        """The whole mixed loss through the fused kernel chain (level 0
        divides, computes SSIM, the windowed L1 and the pool in one pass,
        ``ops/ssimfused.fused_level0_parts``; the middle levels pool in
        their kernel; the last level is single-scale), or None where the
        configuration falls outside the kernels' envelope."""
        if not self.ms or self.dtype is not None:
            return None
        if input.dim() != 4 or input.dtype != torch.float32 or input.shape != target.shape:
            return None
        if set(self.kwargs) - {"weights", "k"}:
            return None
        weights = np.asarray(self.kwargs.get("weights", _MS_WEIGHTS), np.float32)
        levels = len(weights)
        k1, k2 = self.kwargs.get("k", (0.01, 0.03))
        c1, c2 = float(k1) ** 2, float(k2) ** 2  # data_range == 1 (as _ssim_val)
        h, w = input.shape[-2:]
        if h % (1 << (levels - 1)) or w % (1 << (levels - 1)):
            return None  # odd pool dims somewhere in the chain (torch pads)
        if min(h, w) <= (self.win_size - 1) * 2 ** (levels - 1):
            return None
        if not ssimfused.auto_ok(input, self.win_size):
            return None

        s, cs, l1m, x, y = ssimfused.fused_level0_parts(
            input, target, c1, c2, self.win_size, self.win_sigma, divisor
        )
        mcs = [torch.relu(cs)]
        for i in range(1, levels):
            if i < levels - 1:
                s, cs, x, y = ssimfused.fused_ssim_parts_pool(x, y, c1, c2, self.win_size, self.win_sigma)
                mcs.append(torch.relu(cs))
            else:
                s, cs = ssimfused.fused_ssim_parts(x, y, c1, c2, self.win_size, self.win_sigma)
        stacked = torch.stack(mcs + [torch.relu(s)], dim=0)  # (levels, B, C)
        wts = torch.from_numpy(weights).to(stacked.device).view(-1, 1, 1)
        val = torch.prod(stacked**wts, dim=0)
        msv = val.mean() if size_average else val.mean(1)
        loss = 1 - msv
        if self.mix < 1:
            l1 = l1m.mean() if size_average else l1m.mean(1)
            loss = self.mix * loss + (1 - self.mix) * l1
        return loss

    def scaled(self, input, target, divisor):
        """``loss(input / divisor, target / divisor)``, with the exact f32
        divide folded into the level-0 kernel where the fused chain runs,
        so the train loop's /IMAGE_RANGE never forms divided
        full-resolution tensors."""
        input, target = self._cast(input, target)
        fused = self._fused_mix_loss(input, target, float(divisor), size_average=True)
        if fused is not None:
            return fused
        return self(input / divisor, target / divisor)

    def __call__(self, input, target):
        input, target = self._cast(input, target)
        fused = self._fused_mix_loss(input, target, 1.0, size_average=True)
        if fused is not None:
            return fused
        x = 1 - self._ssim_val(input, target, size_average=True)
        if self.mix < 1:
            x = self.mix * x + (1 - self.mix) * self._l1_windowed(input, target, per_sample=False)
        return x

    def per_sample(self, input, target):
        """(B,) per-sample losses, for exact masked reduction over padded batches."""
        input, target = self._cast(input, target)
        fused = self._fused_mix_loss(input, target, 1.0, size_average=False)
        if fused is not None:
            return fused
        x = 1 - self._ssim_val(input, target, size_average=False)
        if self.mix < 1:
            x = self.mix * x + (1 - self.mix) * self._l1_windowed(input, target, per_sample=True)
        return x


def normalize_preds(hr, hr_hat, pmin: float = 0.1, pmax: float = 99.9):
    """Normalizes prediction intensities to ground truth for fair
    benchmarking (reference: pssr/util.py:139-191; percentile min-max,
    mean-centering and covariance amplitude matching from original PSSR).

    NOTE: this algorithm is transcribed from the MIT-licensed reference
    (and csbdeep before it) ON PURPOSE — it defines the benchmarking
    protocol, so numeric identity with the reference is the requirement;
    a re-derivation would risk silently changing published metrics.
    See NOTICE for attribution.

    Args:
        hr (ndarray) : Ground-truth images.

        hr_hat (ndarray) : Prediction images.

        pmin (float) : Percentile minimum intensity. Default 0.1.

        pmax (float) : Percentile maximum intensity. Default 99.9.
    """
    hr, hr_hat = np.asarray(hr), np.asarray(hr_hat)
    if len(hr.shape) != len(hr_hat.shape):
        raise ValueError(
            f"hr and hr_hat must have the same number of dimensions. Dimension lengths are "
            f"{hr.shape} and {hr_hat.shape} respectively."
        )
    hr_shape, hr_hat_shape = hr.shape, hr_hat.shape

    if len(hr.shape) < 3:
        hr, hr_hat = hr[np.newaxis, ...], hr_hat[np.newaxis, ...]
    hr = hr.reshape(-1, *hr.shape[-2:])
    hr_hat = hr_hat.reshape(-1, *hr_hat.shape[-2:])
    if len(hr) != len(hr_hat):
        raise ValueError(
            f"hr and hr_hat must have the same number of images. Received {len(hr)} and "
            f"{len(hr_hat)} images respectively."
        )

    hr_norms, hr_hat_norms = [], []
    for idx in range(len(hr)):
        hr_norm = hr[idx].astype(np.float32)
        hr_hat_norm = hr_hat[idx].astype(np.float32)

        base_max = np.percentile(hr_norm, pmax)
        base_mean = np.mean(hr_norm)

        hr_norm = _normalize_minmax(hr_norm, pmin, pmax)

        hr_hat_norm = hr_hat_norm - np.mean(hr_hat_norm)
        hr_norm = hr_norm - np.mean(hr_norm)

        scaled = (
            resize_bilinear_np(hr_hat_norm, *hr_norm.shape) if hr_hat_norm.shape != hr_norm.shape else hr_hat_norm
        )
        amp = np.cov(scaled.flatten(), hr_norm.flatten())[0, 1] / np.var(hr_hat_norm.flatten())
        hr_hat_norm = amp * hr_hat_norm

        hr_norm, hr_hat_norm = (hr_norm - hr_norm.min()) * base_max, (hr_hat_norm - hr_norm.min()) * base_max
        hr_norm = hr_norm / (hr_norm.mean() / base_mean)
        hr_hat_norm = hr_hat_norm / (hr_hat_norm.mean() / base_mean)

        hr_norms.append(hr_norm)
        hr_hat_norms.append(hr_hat_norm)

    hr = np.asarray(hr_norms).clip(0, 255)
    hr_hat = np.asarray(hr_hat_norms).clip(0, 255)
    return hr.reshape(hr_shape).astype(np.uint8), hr_hat.reshape(hr_hat_shape).astype(np.uint8)


def _normalize_minmax(x, pmin=0.1, pmax=99.9, eps=1e-20, dtype=np.float32):
    """(from csbdeep; reference: pssr/util.py:193-205)"""
    x_min = np.percentile(x, pmin, keepdims=True)
    x_max = np.percentile(x, pmax, keepdims=True)
    x = x.astype(dtype, copy=False)
    return (x - x_min.astype(dtype)) / (x_max.astype(dtype) - x_min.astype(dtype) + dtype(eps))


def pixel_metric(mse, image_range: int = 255):
    """Average pixel error: sqrt(MSE) * range (reference: pssr/util.py:207-215).

    Args:
        mse (float) : Mean squared error between images (on [0,1] scale).

        image_range (int) : Value range of image. Default is 255.
    """
    return math.sqrt(mse) * image_range


def _psnr_metric(mse):
    return 20 * np.log10(1 / np.sqrt(mse))


def _force_list(item):
    if not isinstance(item, list):
        try:
            return list(item)
        except TypeError:
            return [item]
    return item


def _get_callbacks(raw):
    """Arity-sniffing callback protocol: 1-arg callables receive the loop's
    locals() (reference: pssr/util.py:228-231)."""
    callbacks = [] if raw is None else _force_list(raw)
    callback_locals = [
        len([arg for arg in inspect.getfullargspec(cb).args if arg != "self"]) == 1 for cb in callbacks
    ]
    return callbacks, callback_locals
