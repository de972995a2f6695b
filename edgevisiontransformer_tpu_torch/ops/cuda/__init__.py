"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their Python
wrappers.  Counterpart of ``edgevisiontransformer_tpu/ops/pallas``.

Every wrapper takes its plain PyTorch twin for a CPU tensor, and for a CUDA
tensor launches its kernel or raises: there is no fallback.  The kernels are
built on first launch (``build.py``), never on import.
"""
