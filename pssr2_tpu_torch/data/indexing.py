"""Pure index arithmetic for datasets: frame slicing, tile windows,
train/val splitting and shuffling samplers (counterpart:
pssr2_tpu/data/indexing.py, copied as it is).

This is the trickiest pure-logic part of the data layer; semantics are kept
exactly equal to the reference (reference: pssr/data.py:629-752) since the
``len()`` equations, validation membership and tile naming all build on it.
"""

import random as _pyrandom

import numpy as np


def get_n_frames(n_frames):
    """Normalize an ``n_frames`` argument to None or ``[lr, hr]``
    (reference: pssr/data.py:689-695)."""
    if n_frames in [None, -1, [-1]]:
        return None
    if not isinstance(n_frames, list):
        try:
            n_frames = list(n_frames)
        except TypeError:
            n_frames = [n_frames]
    return n_frames * 2 if len(n_frames) == 1 else n_frames


def get_image_idx(idx, slices, tiles=None):
    """Map a flat dataset index to (image_idx, residual_idx)
    (reference: pssr/data.py:697-706)."""
    tiles = [1] * len(slices) if tiles is None else tiles
    image_idx = 0
    for n_slice, n_tile in zip(slices, tiles):
        if idx < n_slice * n_tile:
            return image_idx, idx
        idx -= n_slice * n_tile
        image_idx += 1
    raise IndexError("index out of range for dataset slices")


def get_val_idx(slices, split, seed, tiles=None):
    """Seeded per-image (per-tile for sliding) validation split; always keeps
    >= 1 validation image (reference: pssr/data.py:708-730)."""
    if tiles is not None:
        tile_slices = []
        for n_slice, n_tile in zip(slices, tiles):
            tile_slices.extend([n_slice] * n_tile)
        slices = tile_slices

    val_slices = list(range(len(slices)))
    if seed is not None and split < 1:
        np.random.seed(seed)
        np.random.shuffle(val_slices)
    val_slices = set(val_slices[-max(1, int(split * len(slices))):])

    val_idx, idx = [], 0
    for slice_idx, n_slice in enumerate(slices):
        if slice_idx in val_slices:
            val_idx.extend(range(idx, idx + n_slice))
        idx += n_slice
    return val_idx


def invert_idx(idx, idx_len):
    """Complement of an index list (reference: pssr/data.py:732-735)."""
    idx_range = np.arange(idx_len)
    return idx_range[~np.isin(idx_range, idx)]


def n_tiles(image_shape, size, stride):
    """Number of (x, y) sliding-window tiles over the trailing two dims
    (reference: pssr/data.py:682-687)."""
    x, y = image_shape[-2:]
    tiles_x = max(0, (x - size) // stride + 1)
    tiles_y = max(0, (y - size) // stride + 1)
    return tiles_x, tiles_y


def sliding_window(image, size, stride, n_frames, n_slices, idx, slide):
    """Extract the tile + frame slice addressed by a flat residual index
    (reference: pssr/data.py:629-638)."""
    _, tiles_y = n_tiles(image.shape, size, stride)
    tile_idx = idx // n_slices

    start_x = tile_idx // tiles_y * stride
    start_y = tile_idx % tiles_y * stride
    image = image[..., start_x : start_x + size, start_y : start_y + size]
    return slice_image(image, n_frames, n_slices, idx, slide)


def slice_image(image, n_frames, n_slices, idx, slide):
    """Select the frame window for a residual index
    (reference: pssr/data.py:649-660)."""
    if n_frames is None:
        return image
    idx = idx % n_slices
    if not slide:
        idx *= n_frames
    return image[idx : idx + n_frames]


def slice_center(image, n_frames):
    """Center-crop the frame axis to n_frames (reference: pssr/data.py:662-668)."""
    center = image.shape[-3] // 2
    half = n_frames // 2
    if n_frames % 2 == 0:
        return image[..., center - half : center + half, :, :]
    return image[..., center - half : center + half + 1, :, :]


class RandomIterIdx:
    """Reshuffling index sampler; ``seed=True`` gives the deterministic
    validation order (reference: pssr/data.py:737-752)."""

    def __init__(self, idx, seed=False, rng=None):
        self.idx = list(idx)
        self.seed = seed
        # explicit generator: identical shuffles across hosts (multi-process
        # feeding requires every process to draw the same global order)
        self.rng = rng

    def __iter__(self):
        random_idx = self.idx.copy()
        if self.rng is not None:
            self.rng.shuffle(random_idx)
        elif self.seed:
            np.random.seed(0)
            np.random.shuffle(random_idx)
        else:
            _pyrandom.shuffle(random_idx)
        yield from random_idx

    def __len__(self):
        return len(self.idx)
