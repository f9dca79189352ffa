"""Tiled prediction (counterpart: pssr2_tpu/predict.py:24-186; reference:
pssr/predict.py:11-83): batched eval forward over a dataset's validation
split, written as ``.tif`` files or returned as a dict."""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from . import resolve_device
from .data import tiff
from .data.indexing import slice_center
from .util import _get_callbacks, normalize_preds


def _eval_forward(model, device):
    """numpy (N, C, H, W) [0, 255] -> numpy model output, on ``device``."""
    model.eval().to(device)

    def forward(lr):
        with torch.inference_mode():
            out = model(torch.from_numpy(np.ascontiguousarray(lr, dtype=np.float32)).to(device))
        return out.cpu().numpy()

    return forward


def _pred_array(data, n_frames=1):
    """clip -> uint8 -> center frame (reference: pssr/predict.py:245-246)."""
    return slice_center(np.clip(np.asarray(data), 0, 255).astype(np.uint8), n_frames)


def predict_images(
    model,
    dataset,
    device: str = None,
    batch_size=None,
    out_dir: str = "preds",
    norm: bool = False,
    prefix: str = None,
    dataloader_kwargs=None,
    callbacks=None,
):
    """Predicts high-resolution images from low-resolution images.

    Only uses evaluation images; set ``val_split=1`` to use all images.

    Args:
        model : Any model of the port (``models.ResUNet``,
            ``models.RDResUNet``, ``models.SwinIR``), or an int8 executor
            of ``quant.py`` (``QuantizedResUNet``, ``QuantizedRDResUNet``),
            to receive low-resolution images; moved to ``device``.

        dataset : Dataset to load low-resolution images from.

        device (str) : "cuda" (the default) or "cpu".

        batch_size (int) : Inference batch size (None = 1).

        out_dir (str) : Directory to save images; None returns a dict of
            named images.

        norm (bool) : Normalize prediction intensities to ground truth
            (requires a paired dataset).

        prefix (str) : Output file name prefix.

        dataloader_kwargs (dict) : ``num_workers`` threads load items (default 4).

        callbacks : callables run after each image; one-argument callables
            receive the loop's ``locals()``.
    """
    device = resolve_device(device)
    batch_size = 1 if batch_size is None else batch_size
    if norm and dataset.is_lr:
        raise ValueError("Dataset must be paired with high-low-resolution images for normalization.")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    callbacks, callback_locals = _get_callbacks(callbacks)
    forward = _eval_forward(model, device)

    outs, cur_idx = {}, 0
    val_idx = list(dataset.val_idx)
    num_workers = (dataloader_kwargs or {}).get("num_workers", 4)
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        for start in range(0, len(val_idx), batch_size):
            idx_batch = val_idx[start : start + batch_size]
            items = list(pool.map(dataset.__getitem__, idx_batch))
            if dataset.is_lr:
                lr = np.stack([np.asarray(item) for item in items])
                hr = None
            else:
                hr = np.stack([np.asarray(item[0]) for item in items])
                lr = np.stack([np.asarray(item[1]) for item in items])

            hr_hat = _pred_array(forward(lr))

            if norm:
                _, hr_hat = normalize_preds(_pred_array(hr), hr_hat)

            crop_res = (
                dataset.crop_res
                if not dataset.is_lr
                else dataset.crop_res * (hr_hat.shape[-1] // lr.shape[-1])
            )
            hr_hat = hr_hat[:, :, :crop_res, :crop_res]

            for batch_idx, image_idx in enumerate(range(cur_idx, min(cur_idx + batch_size, len(val_idx)))):
                if out_dir:
                    tiff.imwrite(
                        f"{out_dir}/{prefix + '_' if prefix else ''}{dataset._get_name(image_idx)}.tif",
                        hr_hat[batch_idx],
                    )
                else:
                    outs[dataset._get_name(image_idx)] = hr_hat[batch_idx]

                for idx, callback in enumerate(callbacks):
                    if callback_locals[idx]:
                        callback(locals())
                    else:
                        callback()
            cur_idx += batch_size
            done = min(start + batch_size, len(val_idx))
            print(f"\rpredict_images: {done}/{len(val_idx)}", end="", file=sys.stderr, flush=True)
    print(file=sys.stderr)
    if out_dir is None:
        return outs
