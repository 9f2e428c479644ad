"""PyTorch/CUDA port of the VELTAIR serving system.

Mirrors the layout of the JAX package ``repro`` (``configs``, ``core``,
``kernels``, ``models``, ``serving``) and imports nothing from it.  Entry
points run on the card unless the caller asks for the CPU; on a CUDA
tensor the hot-spot ops run hand-written CUDA kernels, on a CPU tensor
their plain PyTorch versions.
"""
