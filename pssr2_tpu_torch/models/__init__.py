"""Models of the port (counterpart: pssr2_tpu/models): ResUNet, NCHW
[0, 255] at the call boundary, NHWC inside."""

from .resunet import ResUNet

__all__ = ["ResUNet"]
