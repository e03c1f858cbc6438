"""PyTorch/CUDA port of ``ipex_llm_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module paths
(each file names its counterpart) and imports nothing of it.  Entry points
take an explicit ``device`` and run on ``cuda`` unless the caller passes
``device="cpu"``, where every hand-written kernel is replaced by its plain
PyTorch version.

The slice ported so far is the serving engine's paged, ragged tick on a
llama-family decoder in bf16 or sym_int4 weights, with two CUDA kernels:
ragged paged attention (``ops/cuda/ragged_paged_attention.py``) and the int4
dequant-matmul (``ops/cuda/qmatmul.py``).  Configurations outside the slice
raise ``NotImplementedError``.
"""

from ipex_llm_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
