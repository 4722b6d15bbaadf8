"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; nothing is built or loaded until a kernel is first launched.
"""
