"""Pilot-Streaming on PyTorch and CUDA: the port of the JAX package
``repro`` for an NVIDIA H100.

It keeps ``repro``'s layout (``broker``, ``core``, ``engines``,
``streaming``, ``kernels``, ``miniapps``, ...) and imports nothing from it.
This slice carries the Mini-App streaming path: a MASS source publishes to
the broker, the micro-batch engine hands each batch to a MASA processor
(streaming K-Means, GridRec / ML-EM reconstruction), and the processors'
hot loops run hand-written Hopper kernels. Entry points run on CUDA unless
the caller passes a CPU device.
"""
