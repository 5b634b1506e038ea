"""Kernels of the port: each hand-written kernel sits beside its plain
PyTorch version, which tensors on the CPU take instead."""
