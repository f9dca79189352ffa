"""Compute primitives of the port: pixel shuffle, pooling, eval-mode
BatchNorm coefficients, the PIL-matched resize, and the hand-written
convchain kernel (``ops/convchain.py`` + ``csrc/convchain.cu``)."""
