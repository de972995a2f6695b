"""edgevisiontransformer_tpu_torch — the PyTorch / CUDA port.

A second package beside the JAX reference ``edgevisiontransformer_tpu``,
with the same module paths, so each module here has one counterpart there.
The plain tensor code is PyTorch; every Pallas kernel of the reference that
the port covers is a CUDA C++ kernel for Hopper (``csrc/``), built on first
use by ``ops/cuda/build.py`` and bound with ctypes.

This package imports ``torch`` and never JAX, at any depth: the machine with
the GPU has no JAX.  Importing it builds nothing and touches no device.
"""

__version__ = "0.1.0"
