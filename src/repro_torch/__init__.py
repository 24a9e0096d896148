"""Pilot-Streaming on PyTorch and CUDA: the port of the JAX package
``repro`` for an NVIDIA H100.

It keeps ``repro``'s layout (``broker``, ``core``, ``engines``,
``streaming``, ``kernels``, ``miniapps``, ...) and imports nothing from it.
It carries the Mini-App streaming path (a MASS source publishes to the
broker, the micro-batch engine hands each batch to a MASA processor:
streaming K-Means, GridRec / ML-EM reconstruction), LM serving, the
Pipeline API with its elastic control plane, and the continuous engine
with partitioned keyed state, crash checkpoints, fault injection and
preemption; the processors' hot loops run hand-written Hopper kernels.
Entry points run on CUDA unless the caller passes a CPU device.
"""
