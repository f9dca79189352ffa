"""Data layer of the port: the TIFF codec, index arithmetic and
``ImageDataset`` (counterpart: pssr2_tpu/data)."""

from .datasets import ImageDataset

__all__ = ["ImageDataset"]
