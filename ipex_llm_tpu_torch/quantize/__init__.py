"""Block quantization (port of ``ipex_llm_tpu/quantize``): the ten block
formats of the fused dequant-matmul, and bf16."""

from ipex_llm_tpu_torch.quantize.core import QTensor, dequantize, quantize

__all__ = ["QTensor", "dequantize", "quantize"]
