"""Compute primitives of the port: pixel shuffle, pooling, BatchNorm
(train and eval), the PIL-matched resize (host and device), the device
crappifiers, SSIM, and the hand-written kernels: convchain forward and
backward (``ops/convchain.py`` + ``csrc/convchain.cu``,
``csrc/convchain_bwd.cu``), fused SSIM forward and backward
(``ops/ssimfused.py`` + ``csrc/ssimfused.cu``), and the RDNet block tail
forward and backward (``ops/rdtail.py`` + ``csrc/rdtail.cu``)."""
