"""The llama decoder and its weights (port of ``ipex_llm_tpu/models``)."""
