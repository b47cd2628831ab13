"""Kernels of the port, written by hand for Hopper (sm_90a).

Each kernel sits in its own package beside the reference's Pallas
kernel of the same name: the CUDA source, `ops.py` (the wrapper, which
launches the kernel on CUDA tensors and runs the plain version on CPU
tensors, and holds the kernel's `CudaKernel` with its launch count) and
`ref.py` (the plain PyTorch version).
"""
