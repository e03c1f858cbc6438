"""Wrappers of the hand-written CUDA kernels (one module per TPU kernel).

Each wrapper checks its inputs, allocates its output with ``torch.empty``,
counts its launches, and launches the kernel for CUDA tensors.  For CPU
tensors it runs the plain PyTorch version that sits in the same module.
There is no fallback: a CUDA tensor the kernel cannot take raises.
"""
