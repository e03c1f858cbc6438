"""Operators of the decoder (port of ``ipex_llm_tpu/ops``).

Plain tensor code is PyTorch; the two TPU kernels of the serving path are
CUDA C++ under ``ipex_llm_tpu_torch/csrc`` with their wrappers in
``ops/cuda``.
"""
