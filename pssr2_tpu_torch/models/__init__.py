"""Models of the port (counterpart: pssr2_tpu/models): ResUNet,
RDResUNet and SwinIR, NCHW [0, 255] at the call boundary, NHWC inside."""

from .rdresunet import RDResUNet
from .resunet import ResUNet
from .swinir import SwinIR

__all__ = ["RDResUNet", "ResUNet", "SwinIR"]
