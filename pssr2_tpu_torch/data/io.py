"""Host-side image IO and the pair-generation chain that ``ImageDataset``
uses (counterpart: pssr2_tpu/data/io.py:31-230; reference:
pssr/data.py:471-577).  numpy only; PIL is imported lazily, for files
other than TIFF."""

import struct
from pathlib import Path

import numpy as np

from ..crappifiers import Crappifier
from ..ops.resize import resize_bilinear_np
from . import tiff
from .indexing import slice_center, slice_image


def _pil_open(path):
    from PIL import Image

    # microscopy sheets routinely exceed PIL's decompression-bomb threshold
    Image.MAX_IMAGE_PIXELS = None
    return Image.open(path)


def load_image(path, file, mode, n_frames, slices, idx):
    """Decode one pre-tiled image file and select its frame window
    (reference: pssr/data.py:566-577)."""
    extension = file.split(".")[-1].lower()
    if extension in ("tif", "tiff"):
        image = tiff.imread(Path(path, file))
        if image.ndim < 3:
            image = image[np.newaxis]
    else:
        image = frame_channel(_pil_open(Path(path, file)), mode)
    return slice_image(image, n_frames, slices, idx, slide=False)


def frame_channel(image, mode="L"):
    """PIL image -> (frames, H, W) uint8 (reference: pssr/data.py:640-647)."""
    n_frames = getattr(image, "n_frames", 1)
    if n_frames > 1:
        frames = []
        for frame in range(n_frames):
            image.seek(frame)
            frames.append(np.asarray(image.convert(mode), dtype=np.uint8))
        return np.stack(frames)
    return np.asarray(image.convert(mode), dtype=np.uint8)[np.newaxis, :, :]


def probe_shape(path, file):
    """(n_frames, (height, width)) without decoding pixel data where possible
    (reference: pssr/data.py:76-80)."""
    extension = file.split(".")[-1].lower()
    full = Path(path, file)
    if extension in ("tif", "tiff"):
        try:
            n, (h, w) = tiff.num_pages_and_size(full)
            return n, (h, w)
        except (ValueError, KeyError, IndexError, OSError, struct.error):
            pass  # not a TIFF this reader parses: let PIL probe it
    image = _pil_open(full)
    return getattr(image, "n_frames", 1), (image.size[1], image.size[0])


def probe_frames_and_size(path, file):
    """(n_frames, max_side) metadata probe (reference: pssr/data.py:70-74)."""
    n, (h, w) = probe_shape(path, file)
    return n, max(h, w)


def square_crop(image, max_res):
    """Center square crop (reference: pssr/data.py:536-546)."""
    height, width = image.shape[-2:]
    if [height, width] == [max_res] * 2:
        return image
    size = min(height, width, max_res)
    start_x = (height - size) // 2
    start_y = (width - size) // 2
    return image[:, start_x : start_x + size, start_y : start_y + size]


def pad_image(image, res):
    """Reflect-pad bottom/right up to res (reference: pssr/data.py:548-551)."""
    if image.shape[-1] < res:
        pad = res - image.shape[-1]
        return np.stack([np.pad(channel, pad_width=[[0, pad]] * 2, mode="reflect") for channel in image])
    return image


def apply_rotation(image, rotation):
    """rotation = [rot90?, flip-axis] (reference: pssr/data.py:478-480)."""
    if rotation:
        image = np.rot90(image, axes=(1, 2)) if rotation[0] else image
        image = np.flip(image, axis=rotation[1])
    return image


def downscale_pil_like(hr, lr_res):
    """PIL-BILINEAR-matched downscale with uint8 rounding, as the reference
    produces integer-valued LR before crappification (pssr/data.py:483)."""
    lr = resize_bilinear_np(hr, lr_res, lr_res)
    return np.clip(np.round(lr), 0, 255).astype(np.float32)


def array_ready(image, transforms):
    """Finalize to float32 and run user transforms
    (reference _tensor_ready: pssr/data.py:526-534)."""
    image = np.ascontiguousarray(image).astype(np.float32)
    if transforms is not None:
        for transform in transforms:
            image = transform(image)
    return image


def gen_pair(hr, hr_res, lr_scale, rotation, crappifier, transforms, n_frames):
    """HR patch -> (hr, lr) pair with crappification
    (reference: pssr/data.py:471-495)."""
    hr = square_crop(hr, hr_res)
    hr = pad_image(hr, hr_res)
    hr = apply_rotation(hr, rotation)

    lr = downscale_pil_like(hr, hr_res // lr_scale)
    if crappifier is not None:
        lr = crappifier.crappify(lr) if isinstance(crappifier, Crappifier) else crappifier(lr)
        lr = np.clip(np.asarray(lr).round(), 0, 255)

    if n_frames is not None and n_frames[0] != n_frames[1]:
        if not n_frames[1] > hr.shape[-3]:
            hr = slice_center(hr, n_frames[1])
        if not n_frames[0] > lr.shape[-3]:
            lr = slice_center(lr, n_frames[0])

    return array_ready(hr, transforms), array_ready(lr, transforms)


def ready_lr(lr, lr_res, transforms):
    """LR-mode item processing (reference: pssr/data.py:518-524)."""
    lr = square_crop(lr, lr_res)
    lr = pad_image(lr, lr_res)
    return array_ready(lr, transforms)
