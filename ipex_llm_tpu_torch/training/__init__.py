"""Training: the causal-LM step, QLoRA, ReLoRA, LISA, checkpoints and the
HF Trainer bridge (port of ``ipex_llm_tpu/training``).

The loss runs the decoder's training form (``models/decoder.py``,
``cache=None``): every base linear through B2 and its input gradient
through B2^T (``ops/cuda/qmatmul_dx.py``), attention through B4's LSE
instance and its backward kernels (``ops/cuda/flash_attention_bwd.py``),
the LoRA products and the full-parameter bf16 products as plain
``torch.matmul``.  Optimizers are ``torch.optim`` ones
(``training.step.init_optimizer``).  MoE experts, windows, softcaps and
head_dim 256 under a gradient raise (ROADMAP item 16's remainder).

    from ipex_llm_tpu_torch.training import LoraConfig, get_peft_model
    peft = get_peft_model(model, LoraConfig(r=8, lora_alpha=16))
    peft.compile(functools.partial(torch.optim.Adam, lr=2e-4))
    loss = peft.train_step(tokens)          # [B, T] ids
    model = peft.merge_and_unload()
"""

from ipex_llm_tpu_torch.training.checkpoint import TrainCheckpointer
from ipex_llm_tpu_torch.training.hf_trainer import (TPUTrainer,
                                                    patch_transformers_trainer)
from ipex_llm_tpu_torch.training.lisa import LisaTrainer, make_lisa_train_step
from ipex_llm_tpu_torch.training.qlora import (LoraConfig, LoraWeight,
                                               PeftModel, attach_lora,
                                               get_peft_model, init_lora,
                                               make_qlora_train_step,
                                               merge_lora)
from ipex_llm_tpu_torch.training.relora import (ReLoRATrainer,
                                                jagged_cosine_schedule)
from ipex_llm_tpu_torch.training.step import (causal_lm_loss,
                                              init_optimizer,
                                              make_train_step)

__all__ = [
    "TPUTrainer", "patch_transformers_trainer",
    "causal_lm_loss", "make_train_step", "init_optimizer",
    "LoraConfig", "LoraWeight", "PeftModel", "attach_lora", "get_peft_model",
    "init_lora", "make_qlora_train_step", "merge_lora",
    "ReLoRATrainer", "jagged_cosine_schedule", "TrainCheckpointer",
    "LisaTrainer", "make_lisa_train_step",
]
