"""HF-shaped entry points (port of ``ipex_llm_tpu/transformers``)."""
