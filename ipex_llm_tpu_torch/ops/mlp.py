"""MLP activations (port of ``ipex_llm_tpu/ops/mlp.py``): SwiGLU, the
tanh GELU of gemma2 and gemma3 (``gelu_pytorch_tanh``, the reference's
``jax.nn.gelu(approximate=True)``) and of phi, phixtral and gptj
(``gelu_new``, the same function), and HF's ``gelu``, the exact erf form
(``jax.nn.gelu(approximate=False)``), which a published Gemma config
without ``hidden_activation`` and GPT-NeoX resolve to.  :func:`act` is the
ungated MLP's activation (fc1 -> act -> fc2), :func:`gated_act_mul` the
gated one's."""

from __future__ import annotations

import torch
import torch.nn.functional as F


ACT_FNS = {
    "silu": F.silu,
    "gelu": F.gelu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
}


def _fn(name: str):
    if name not in ACT_FNS:
        raise NotImplementedError(f"activation {name!r} is not ported")
    return ACT_FNS[name]


def act(x: torch.Tensor, name: str = "gelu_new") -> torch.Tensor:
    """The plain activation of an ungated MLP: in fp32, cast back to
    ``x.dtype`` (the reference's rounding points)."""
    return _fn(name)(x.to(torch.float32)).to(x.dtype)


def gated_act_mul(gate: torch.Tensor, up: torch.Tensor,
                  act: str = "silu") -> torch.Tensor:
    """act(gate) * up: the activation in fp32, cast to ``up.dtype``, then
    the product in that dtype (the reference's rounding points)."""
    return _fn(act)(gate.to(torch.float32)).to(up.dtype) * up


def split_gate_up(gate_up: torch.Tensor):
    """Split a merged gate_up projection output into (gate, up)."""
    d = gate_up.shape[-1] // 2
    return gate_up[..., :d], gate_up[..., d:]
