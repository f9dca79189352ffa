"""Models of the port (counterpart: pssr2_tpu/models): ResUNet and
RDResUNet, NCHW [0, 255] at the call boundary, NHWC inside."""

from .rdresunet import RDResUNet
from .resunet import ResUNet

__all__ = ["RDResUNet", "ResUNet"]
