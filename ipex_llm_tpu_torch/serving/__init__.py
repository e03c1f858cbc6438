"""The continuous-batching engine (port of ``ipex_llm_tpu/serving``)."""
