"""Parameter-tree helpers of the serving engine's weight axis (port of the
``requantize_params`` and ``param_bytes`` half of
``ipex_llm_tpu/models/build.py``; checkpoint loading is not ported).
"""

from __future__ import annotations

import math

import torch

from ipex_llm_tpu_torch.quantize.core import QTensor, quantize
from ipex_llm_tpu_torch.quantize.qtypes import resolve


def _requant_leaf(qt: QTensor, qtype: str) -> QTensor:
    """Re-pack one native-width QTensor (2-D, or stacked with leading axes)
    into ``qtype``: each logical ``[in, out]`` matrix quantizes on its own
    (over the stored bf16 values), then the planes restack along the
    original leading axes."""
    lead = tuple(qt.data.shape[:-2])
    flat = qt.data.reshape((-1,) + tuple(qt.shape))
    qts = [quantize(m, qtype) for m in flat]

    def restack(leaves):
        if leaves[0] is None:
            return None
        s = torch.stack(leaves)
        return s.reshape(lead + tuple(s.shape[1:])) if lead else s[0]

    return QTensor(restack([q.data for q in qts]),
                   restack([q.scales for q in qts]),
                   restack([q.zeros for q in qts]),
                   qts[0].qtype, qt.shape, qts[0].block_size)


def requantize_params(params: dict, qtype: str) -> dict:
    """Re-pack every native-width linear QTensor of a tree (stacked layer
    leaves and the lm head) as ``qtype`` planes: the engine's
    ``EngineConfig.weight_qtype`` axis.

    Plain tensors (embedding, norms, rope buffers) keep their width, and
    already-packed leaves pass through untouched: requantizing packed codes
    would stack quantization error.  An unknown name raises ``ValueError``
    at once; a format outside the port raises ``NotImplementedError`` only
    when a full-width leaf actually needs its codec, so an already-packed
    tree passes through whatever is asked."""
    try:
        info = resolve(qtype)
    except NotImplementedError as exc:
        info, missing = None, exc
    if info is not None and info.kind == "native":
        return params

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if not isinstance(tree, QTensor) or resolve(tree.qtype).kind \
                != "native":
            return tree
        if info is None:
            raise NotImplementedError(
                f"weight_qtype={qtype!r} has no codec in the port for the "
                f"full-width weight {'.'.join(path)}") from missing
        return _requant_leaf(tree, info.name)

    return walk(params)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def param_bytes(params: dict) -> tuple[int, int]:
    """(packed_bytes, dense_bytes): what the tree holds on its device as
    stored, and what it would hold with every QTensor at bf16 full width
    (other tensors count the same on both sides)."""
    packed = dense = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor):
            packed += leaf.nbytes
            dense += (math.prod(leaf.data.shape[:-2]) * leaf.in_features
                      * leaf.out_features * 2)
        elif isinstance(leaf, torch.Tensor):
            n = leaf.numel() * leaf.element_size()
            packed += n
            dense += n
    return packed, dense


def packed_qtypes(params: dict) -> tuple[str, ...]:
    """The block formats the tree's QTensors carry (native widths left
    out), sorted."""
    return tuple(sorted({leaf.qtype for leaf in _leaves(params)
                         if isinstance(leaf, QTensor)
                         and resolve(leaf.qtype).kind != "native"}))
