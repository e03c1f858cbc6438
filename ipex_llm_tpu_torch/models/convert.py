"""Carry a parameter tree of the JAX reference into the port.

The reference's tree (``ipex_llm_tpu/models/build.py``) arrives as nested
dicts of numpy arrays, its ``QTensor`` leaves flattened to dicts
``{data, scales, zeros, qtype, shape, block_size}`` (the port cannot
import the reference's class).  Every byte is kept: bf16 arrays, which
numpy holds in an extension dtype, cross through a 16-bit integer view,
and packed planes are copied as they are.  Stacked ``[L, ...]`` layer
leaves stay stacked (the decoder indexes them per layer), in each of the
tree's stacks (``layers``, and DeepSeek's dense prefix ``layers_dense``);
the ported families' trees (minicpm's is llama's, minicpm3's DeepSeek's
MLA leaves over dense layers; olmo2's flat ``q_norm``/``k_norm``, ``q_dim``
and ``kv_dim`` wide, and the norms it applies after each branch, which
both packages keep as ``attn_norm``/``mlp_norm``; falcon's, starcoder2's,
stablelm's and cohere's LayerNorms with or without their biases) need no
leaf of their own.
:func:`params_from_split_reference` carries an offloaded MoE's split
params (the device tree and its host expert stacks) as one tree.
:func:`adapters_from_reference` carries a QLoRA adapter tree likewise, so
that both packages train from the same adapters (the reference draws them
from JAX keys, which the port does not reproduce).
"""

from __future__ import annotations

import numpy as np
import torch

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.quantize.core import QTensor
from ipex_llm_tpu_torch.quantize.qtypes import resolve

_QTENSOR_KEYS = {"data", "scales", "zeros", "qtype", "shape", "block_size"}
# the tree of the ported families (qwen2's qkv bias, gemma2's post norms
# and its tied head, which has no lm_head leaf, qwen3's q/k norms, the MoE
# families' router, [L, E, ...] expert stacks and qwen2_moe's shared
# expert, gemma3's local rope table, DeepSeek's MLA leaves, score bias and
# dense-prefix stack, the GPT-style block's norm, o, MLP, head and expert
# biases and its ungated MLP's up); anything else (a gated MLP's gate/up
# bias, a quantized embedding) raises
_LAYER_KEYS = {"attn_norm", "mlp_norm", "qkv", "o", "gate_up", "down",
               "qkv_bias", "post_attn_norm", "post_mlp_norm", "q_norm",
               "k_norm", "router", "moe_gate_up", "moe_down",
               "shared_gate_up", "shared_down", "shared_router",
               "router_bias", "q", "q_a", "q_a_norm", "q_b", "kv_a",
               "kv_a_norm", "kv_b", "attn_norm_bias", "mlp_norm_bias",
               "o_bias", "up", "up_bias", "down_bias", "moe_up_bias",
               "moe_down_bias"}
_STACKS = ("layers", "layers_dense")
_TOP_KEYS = {*_STACKS, "embed", "final_norm", "final_norm_bias", "lm_head",
             "lm_head_bias", "inv_freq", "inv_freq_local", "rope_mscale"}


def array_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``, byte for byte (copied, so
    the tensor never aliases the caller's buffer)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.int16), copy=True))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _leaf(x, device):
    if isinstance(x, dict) and set(x) == _QTENSOR_KEYS:
        resolve(x["qtype"])     # raises for formats outside the slice

        def plane(key):
            return None if x[key] is None else array_to_torch(x[key], device)
        return QTensor(plane("data"), plane("scales"), plane("zeros"),
                       x["qtype"], tuple(int(s) for s in x["shape"]),
                       int(x["block_size"]))
    if isinstance(x, (float, int)):
        return x
    return array_to_torch(x, device)


def params_from_reference(tree: dict, device=None) -> dict:
    """The port's params for a reference tree of a ported family (see the
    module doc)."""
    dev = resolve_device(device)
    stacks = [k for k in _STACKS if k in tree]
    extra = set(tree) - _TOP_KEYS
    for k in stacks:
        extra |= set(tree[k]) - _LAYER_KEYS
    if extra:
        raise NotImplementedError(
            f"parameter leaves outside the slice: {sorted(extra)}")
    out = {k: _leaf(v, dev) for k, v in tree.items() if k not in stacks}
    for k in stacks:
        out[k] = {n: _leaf(v, dev) for n, v in tree[k].items()}
    return out


def params_from_split_reference(device_params: dict, host_slots: dict,
                                device=None) -> dict:
    """The port's whole tree for an offloaded MoE that the reference split
    (``ipex_llm_tpu/offload.py::split_expert_params``: the device tree
    without its expert stacks, and ``host_slots``, slot -> the stacked
    expert planes, flattened as any QTensor leaf): the stacks go back into
    ``layers``, from which the port's ``OffloadedMoE`` splits them
    again."""
    tree = dict(device_params)
    tree["layers"] = {**device_params["layers"], **host_slots}
    return params_from_reference(tree, device)


def adapters_from_reference(adapters: dict, device=None) -> dict:
    """The port's adapter tree ``{slot: {"a": [L, in, r], "b": [L, r,
    out]}}`` for the reference's (numpy arrays), byte for byte."""
    dev = resolve_device(device)
    return {slot: {k: array_to_torch(ab[k], dev) for k in ("a", "b")}
            for slot, ab in adapters.items()}
