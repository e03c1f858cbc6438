"""Block quantization (port of ``ipex_llm_tpu/quantize``): sym_int4 and bf16."""

from ipex_llm_tpu_torch.quantize.core import QTensor, dequantize, quantize

__all__ = ["QTensor", "dequantize", "quantize"]
