"""PyTorch/CUDA port of ``ipex_llm_tpu`` for NVIDIA Hopper.

The JAX package stays the reference; this package mirrors its module paths
(each file names its counterpart) and imports nothing of it.  Entry points
take an explicit ``device`` and run on ``cuda`` unless the caller passes
``device="cpu"``, where every hand-written kernel is replaced by its plain
PyTorch version.

Ported so far: the serving engine's paged, ragged tick on a llama-family
decoder with weights in bf16 or any of the ten block formats (repacked
from bf16 through ``EngineConfig.weight_qtype``), with prompt-lookup
speculative decoding (``EngineConfig.spec_k``), and the HF-shaped
``generate()`` over the dense cache, the model API that loads a local HF
checkpoint (``transformers.AutoModelForCausalLM.from_pretrained``,
``save_low_bit``/``load_low_bit``, ``optimize.optimize_model``) and the
server's ``build_server``/``main``, with five CUDA kernels: ragged paged
attention, the dequant-matmul in all ten formats (``ops/cuda/qmatmul.py``),
dense decode attention, flash attention, and split paged attention (the
ragged kernel's oracle at the verify shapes).  Training
(``training/``: the causal-LM step, QLoRA, ReLoRA, LISA, checkpoints and
the HF Trainer bridge, ``llm_patch(train=True)``) runs the same decoder
with two backward kernels, B2's input gradient and flash attention's
backward.  Configurations outside the port raise ``NotImplementedError``.
"""

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.llm_patching import llm_patch, llm_unpatch

__all__ = ["resolve_device", "llm_patch", "llm_unpatch"]
