"""Utilities of the prediction slice: prediction normalization, the pixel
metric and the callback protocol (counterpart: pssr2_tpu/util.py:301-411;
reference: pssr/util.py)."""

import inspect
import math

import numpy as np

from .ops.resize import resize_bilinear_np


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
