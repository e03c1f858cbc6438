"""HF-compatible entry points (port of ``ipex_llm_tpu/transformers``).

    from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
    model = AutoModelForCausalLM.from_pretrained(path,
                                                 load_in_low_bit="sym_int4")
"""

from ipex_llm_tpu_torch.transformers.model import (
    AutoModel,
    AutoModelForCausalLM,
    AutoModelForMaskedLM,
    AutoModelForSeq2SeqLM,
    AutoModelForSequenceClassification,
    AutoModelForSpeechSeq2Seq,
    AutoModelForVision2Seq,
    TPUModelForCausalLM,
)

__all__ = [
    "AutoModel",
    "AutoModelForCausalLM",
    "AutoModelForMaskedLM",
    "AutoModelForSeq2SeqLM",
    "AutoModelForSequenceClassification",
    "AutoModelForSpeechSeq2Seq",
    "AutoModelForVision2Seq",
    "TPUModelForCausalLM",
]
