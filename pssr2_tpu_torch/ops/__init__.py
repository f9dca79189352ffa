"""Compute primitives of the port: pixel shuffle, pooling, BatchNorm
(train and eval), the PIL-matched resize (host and device), the device
crappifiers, SSIM, the GELU / LayerNorm helpers of the fused blocks
(``ops/blockmath.py``), and the hand-written kernels: convchain forward
and backward (``ops/convchain.py`` + ``csrc/convchain.cu``,
``csrc/convchain_bwd.cu``), fused SSIM forward and backward
(``ops/ssimfused.py`` + ``csrc/ssimfused.cu``), the RDNet block tail
forward and backward (``ops/rdtail.py`` + ``csrc/rdtail.cu``), and the
whole Swin block forward and backward and the window attention
(``ops/swinblock.py``, ``ops/winattn.py`` + ``csrc/swinblock.cu``), the
soft histogram forward and backward (``ops/gradhist.py`` +
``csrc/gradhist.cu``), the per-channel dual sums of BatchNorm
(``ops/chanstats.py`` + ``csrc/chanstats.cu``) and the int8 conv layer
(``ops/q8chain.py`` + ``csrc/q8chain.cu``)."""
