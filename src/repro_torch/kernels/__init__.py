"""Hand-written Hopper kernels, their plain PyTorch versions, and dispatch.

Kernels: fused RMSNorm (Triton); flash-attention forward and backward,
ring-cache and paged decode attention, the RG-LRU scan (CUDA C++).  ``ops``
picks the kernel for a CUDA tensor and the plain version (``ref``) for a
CPU tensor, and wraps the norm, prefill attention and the scan in autograd
Functions for training.
"""
