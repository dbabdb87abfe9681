"""Kernels of the port: CUDA C++ for sm_90a under ``csrc/``, each with its
plain PyTorch version in the same module.  A wrapper runs the plain version
for a CPU tensor and launches the kernel for a CUDA tensor (or raises)."""
