"""``ImageDataset``, host-side (counterpart: pssr2_tpu/data/datasets.py:
97-268; reference: pssr/data.py:12-130).  Same arguments, length
arithmetic, validation split, LR mode and naming; items are float32
[0, 255] channel-first numpy arrays, and ``hr_patch`` gives the raw uint8
HR patch that the training pipeline degrades on the device.
"""

import glob
import random
import warnings
from pathlib import Path

import numpy as np

from ..crappifiers import Crappifier, Poisson
from .indexing import get_image_idx, get_n_frames, get_val_idx, slice_image
from .io import (
    apply_rotation,
    array_ready,
    gen_pair,
    load_image,
    pad_image,
    probe_frames_and_size,
    probe_shape,
    ready_lr,
    square_crop,
)

_DEFAULT_CRAPPIFIER = object()  # sentinel: default Poisson(), but explicit None disables noise


def _root_glob(search, root_dir, recursive: bool = True):
    """Recursive sorted glob relative to root (reference: pssr/data.py:675-680)."""
    if recursive:
        files = glob.glob(f"{root_dir}/**/{search}", recursive=True)
    else:
        files = glob.glob(f"{root_dir}/{search}")
    return sorted([item.split(str(root_dir), maxsplit=1)[-1].strip("/") for item in files])


def _as_path(path):
    return Path(path) if isinstance(path, str) else path


def _check_path(path):
    if not path or not path.exists():
        raise FileNotFoundError(f'Path "{path}" does not exist.')


def _glob_or_raise(path, extension):
    files = _root_glob(f"*.{extension}", root_dir=path)
    if not files:
        raise FileNotFoundError(f'No .{extension} files exist in path "{path}".')
    return files


def _random_rotation():
    return [bool(random.getrandbits(1)), random.choice((1, 2, (1, 2)))]


def _check_extra_shape(file, shape, frames, extra_shape, extra_frames, extra_scale, n_frames):
    """Init-time validation of extra-image shape and frame-count agreement
    (reference: pssr/data.py:76-80, 212-216)."""
    needed_extra = tuple(size * extra_scale for size in shape)
    if tuple(extra_shape) != needed_extra:
        raise ValueError(
            f'The corresponding image to "{file}" does not have the correct shape. '
            f'From image shape of {tuple(shape)} and "extra_scale" of {extra_scale}, '
            f"expected extra image shape of {needed_extra}, but got {tuple(extra_shape)}."
        )
    if frames != extra_frames and n_frames is not None:
        raise ValueError(
            f'The corresponding image to "{file}" does not have the correct number of '
            f"frames. n_frames must be -1 if number of image and extra_image frames are "
            f"not equal. Respective number of frames are {frames} and {extra_frames}"
        )


class _DatasetBase:
    """Shared iteration protocol."""

    def __iter__(self):
        for idx in range(len(self)):
            yield self[idx]


class ImageDataset(_DatasetBase):
    def __init__(
        self,
        path: Path,
        hr_res: int = 512,
        lr_scale: int = 4,
        crappifier: Crappifier = _DEFAULT_CRAPPIFIER,
        n_frames: list[int] = -1,
        extension: str = "tif",
        val_split: float = 0.1,
        rotation: bool = True,
        split_seed: int = 0,
        extra_path: Path = None,
        extra_scale: int = 1,
        transforms: list = None,
        preload: bool = False,
    ):
        """Dataset of pre-tiled high-resolution image files, returning
        (hr, lr) pairs with on-the-fly crappification.

        LR mode (loads only unmodified low-resolution images for prediction)
        is enabled when images are <= ``hr_res/lr_scale`` or ``lr_scale=-1``.
        ``preload`` keeps the decoded images in host RAM.
        """
        self.path = _as_path(path)
        _check_path(self.path)
        self.hr_files = _glob_or_raise(self.path, extension)

        if extra_path is not None:
            self.extra_path = _as_path(extra_path)
            _check_path(self.extra_path)
            self.extra_hr_files = _glob_or_raise(self.extra_path, extension)
            if len(self.hr_files) != len(self.extra_hr_files):
                raise FileNotFoundError(
                    f'Number of files in "path" and "extra_path" are not equal. Found '
                    f"{len(self.hr_files)} files and {len(self.extra_hr_files)} files respectively."
                )
        else:
            self.extra_path = None
            self.extra_hr_files = None

        lr_scale = None if lr_scale == -1 else lr_scale
        self.mode = "L"
        self.n_frames = get_n_frames(n_frames)

        self.slices, max_size = [], 0
        for image_idx in range(len(self.hr_files)):
            if self.extra_hr_files is not None:
                frames, shape = probe_shape(self.path, self.hr_files[image_idx])
                size = max(shape)
                eframes, eshape = probe_shape(self.extra_path, self.extra_hr_files[image_idx])
                _check_extra_shape(
                    self.hr_files[image_idx], shape, frames, eshape, eframes, extra_scale, self.n_frames
                )
            else:
                frames, size = probe_frames_and_size(self.path, self.hr_files[image_idx])
            self.slices.append(1 if self.n_frames is None else frames // max(self.n_frames))
            max_size = max(size, max_size)

        self.val_idx = get_val_idx(self.slices, val_split, split_seed)
        self.crop_res = min(hr_res, max_size)

        self.is_lr = lr_scale is None or max_size <= hr_res // lr_scale
        if self.is_lr:
            print("LR mode is enabled, dataset will load only unmodified low-resolution images.")
            if val_split < 1:
                warnings.warn(
                    "val_split is less than 1, not all low-resolution images will be used in prediction.",
                    stacklevel=2,
                )

        self.hr_res = hr_res
        self.lr_scale = lr_scale if lr_scale is not None else 1
        self.crappifier = Poisson() if crappifier is _DEFAULT_CRAPPIFIER else crappifier
        self.rotation = rotation
        self.extra_scale = extra_scale
        self.transforms = transforms

        self.preload = None
        if preload:
            self.preload = [load_image(self.path, f, self.mode, None, 1, 0) for f in self.hr_files]

    def _n(self):
        return max(self.n_frames) if self.n_frames is not None else None

    def _load(self, image_idx, idx):
        if self.preload is not None:
            return slice_image(self.preload[image_idx], self._n(), self.slices[image_idx], idx, slide=False)
        return load_image(
            self.path, self.hr_files[image_idx], self.mode, self._n(), self.slices[image_idx], idx
        )

    def __getitem__(self, idx, pp=False):
        if idx >= len(self):
            raise IndexError(
                f"Tried to retrieve invalid image. Index {idx} is not less than "
                f"{len(self)} total image frame slices."
            )
        is_val = idx in self.val_idx or pp
        image_idx, idx = get_image_idx(idx, self.slices)

        hr = self._load(image_idx, idx)
        cur_rot = _random_rotation() if self.rotation and not is_val else False

        if self.is_lr:
            out = ready_lr(hr, self.hr_res // self.lr_scale, self.transforms)
        else:
            out = gen_pair(hr, self.hr_res, self.lr_scale, cur_rot, self.crappifier, self.transforms, self.n_frames)

        if self.extra_hr_files is not None:
            extra = load_image(
                self.extra_path, self.extra_hr_files[image_idx], self.mode, self._n(),
                self.slices[image_idx], idx,
            )
            extra = apply_rotation(extra, cur_rot)
            extra = array_ready(extra, self.transforms)
            return out, extra
        return out

    def hr_patch(self, idx):
        """Raw uint8 HR window for the device pipeline (crop and pad only;
        rotation, downscale and crappification happen on the device)."""
        image_idx, idx = get_image_idx(idx, self.slices)
        hr = self._load(image_idx, idx)
        hr = square_crop(hr, self.hr_res)
        hr = pad_image(hr, self.hr_res)
        return np.ascontiguousarray(hr).astype(np.uint8)

    def __len__(self):
        return sum(self.slices)

    def __repr__(self):
        res = (
            f"low-res: {self.hr_res // self.lr_scale}"
            if self.is_lr
            else f"high-res: {self.hr_res}, low-res: {self.hr_res // self.lr_scale}"
        )
        return (
            f'ImageDataset from path "{self.path}"\n'
            f"{len(self.hr_files)} files with {len(self)} total frame slices\n{res}"
        )

    def _get_name(self, idx):
        image_idx, idx = get_image_idx(idx, self.slices)
        return self.hr_files[image_idx].split(".")[0] + (f"_{idx}" if self.n_frames is not None else "")
