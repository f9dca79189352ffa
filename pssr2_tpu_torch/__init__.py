"""PSSR2 on PyTorch and CUDA for an NVIDIA H100: the port of ``pssr2_tpu``.

Module names follow the JAX package, so each module here has its
counterpart at the same path under ``pssr2_tpu``.  This package imports
torch, numpy, scipy and the standard library only: nothing of JAX and
nothing of ``pssr2_tpu``.

Device rule: entry points (``ResUNet(...)``, ``RDResUNet(...)``,
``SwinIR(...)``, ``predict_images``, ``train_paired``,
``train_crappifier``) run on
``cuda`` unless the caller passes ``device="cpu"``.  With no card and no
explicit CPU request they raise; they never fall back to the CPU.
``quant.quantize_resunet`` / ``quantize_rdresunet`` build int8 executors
on the model's device; ``train.approximate_crappifier`` runs on the host.

Float32 convolutions and matrix products run in true f32 (TF32 off), as
the JAX reference computes them; the flags are set once when the package
is imported.
"""

import torch

from .crappifiers import Crappifier, Poisson

__version__ = "0.1.0"

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device with no card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pssr2_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run on the CPU."
        )
    return device


__all__ = ["__version__", "resolve_device", "Crappifier", "Poisson"]
