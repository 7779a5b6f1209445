"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

`build` compiles ``repro_torch/csrc/*.cu`` with nvcc at first use; each
kernel's Python wrapper takes its plain version for CPU tensors and launches
the kernel (or raises) for CUDA tensors.
"""
