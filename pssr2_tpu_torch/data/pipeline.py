"""The training input pipeline (counterpart: pssr2_tpu/data/pipeline.py:
23-189): host loader threads read raw uint8 HR patches; augmentation, the
PIL-matched downscale and crappification run on the device, in the train
step, from an explicit ``torch.Generator`` in place of ``jax.random`` keys.

Not ported yet: the host-crappifier fallback (``host_fallback``), the
multi-host feed (``pad_to``, ``local_slice``) and ``prefetch_to_device``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops.degrade import to_device_fn
from ..ops.resize import resize_bilinear
from .indexing import slice_center


def _augment(x, rot, choice):
    """rot90 (over H, W) where ``rot`` holds, then flip H (``choice`` 0),
    W (1) or both (2), per sample of a square (B, C, H, W) batch."""
    if x.shape[-1] != x.shape[-2]:
        raise ValueError(f"augmentation takes square patches, got {tuple(x.shape[-2:])}")
    sel = (-1, 1, 1, 1)
    x = torch.where(rot.view(sel), torch.rot90(x, 1, (2, 3)), x)
    choice = choice.view(sel)
    return torch.where(choice == 0, x.flip(2), torch.where(choice == 1, x.flip(3), x.flip((2, 3))))


def device_augment(generator, x):
    """Per-sample random rot90/flip of a (B, C, H, W) batch, matching the
    host distribution (reference: pssr/data.py:108 — p=0.5 rot90, then
    always one of flip-H / flip-W / flip-both uniformly)."""
    b = x.shape[0]
    rot = torch.rand(b, generator=generator, device=x.device) < 0.5
    choice = torch.randint(0, 3, (b,), generator=generator, device=x.device)
    return _augment(x, rot, choice)


def make_device_gen_pair(lr_scale: int, crappifier, n_frames=None, augment: bool = True):
    """The device-side ``gen_pair`` (reference: pssr/data.py:471-495):
    augment -> PIL-matched downscale (two f32 matrix products) -> uint8
    rounding -> crappify -> uint8 rounding.  Returns
    ``fn(generator, hr_u8) -> (hr_f32, lr_f32)`` for a (B, C, H, W) uint8
    batch on the generator's device."""
    crappify_fn = to_device_fn(crappifier) if crappifier is not None else None
    if crappifier is not None and crappify_fn is None:
        raise ValueError(
            f"Crappifier {type(crappifier).__name__} has no device form in the port yet "
            "(ops/degrade.to_device_fn)."
        )

    def gen_pair(generator, hr_u8):
        if augment:
            # in uint8: rot90 and flips are permutations, exact before the cast
            hr_u8 = device_augment(generator, hr_u8)
        hr = hr_u8.float()

        lr_res = hr.shape[-1] // lr_scale
        lr = resize_bilinear(hr, lr_res, lr_res)
        lr = torch.clamp(torch.round(lr), 0, 255)  # uint8 rounding, as PIL produces

        if crappify_fn is not None:
            lr = torch.clamp(torch.round(crappify_fn(generator, lr)), 0, 255)

        if n_frames is not None and n_frames[0] != n_frames[1]:
            if not n_frames[1] > hr.shape[-3]:
                hr = slice_center(hr, n_frames[1])
            if not n_frames[0] > lr.shape[-3]:
                lr = slice_center(lr, n_frames[0])
        return hr, lr

    return gen_pair


class PatchLoader:
    """Threaded host loader yielding padded uint8 HR patch batches.

    Yields ``(batch_u8 (B, C, H, W) numpy, n_valid)`` where the batch is
    padded up to ``batch_size`` by repeating the last sample; ``n_valid``
    marks the real count so the train step can slice exactly (loss parity
    with the reference's variable last batch).
    """

    def __init__(self, dataset, sampler, batch_size: int, num_workers: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = num_workers

    def __len__(self):
        return (len(self.sampler) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = list(self.sampler)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []  # two batches ahead
            for start in range(0, len(order), self.batch_size):
                idx = order[start : start + self.batch_size]
                rows = [idx[min(r, len(idx) - 1)] for r in range(self.batch_size)]
                pending.append((pool.map(self.dataset.hr_patch, rows), len(idx)))
                if len(pending) > 2:
                    yield self._finalize(*pending.pop(0))
            while pending:
                yield self._finalize(*pending.pop(0))

    @staticmethod
    def _finalize(patches, n_valid):
        return np.stack(list(patches)), n_valid
