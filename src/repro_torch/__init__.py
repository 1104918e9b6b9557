"""MDInference serving stack in PyTorch, with hand-written Hopper kernels.

The port of the JAX package ``repro``: the same module layout and names,
PyTorch tensors and ``nn``-free parameter dicts inside, and CUDA C++ /
Triton kernels for the TPU kernels on the serving path.  It imports
``torch``, numpy and the standard library only.  Entry points run on the
CUDA device unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
