"""Quantized checkpoint save and load (``save_low_bit`` / ``load_low_bit``;
port of ``ipex_llm_tpu/models/serialize.py``).

The files are the reference's, so either package loads what the other
wrote: ``bigdl_config.json`` (``load_in_low_bit`` and a manifest of the
QTensor leaves' ``qtype``/``shape``/``block_size``, the scalar leaves and
the bf16 leaves, ``version`` 1), ``model_low_bit.safetensors`` (each
QTensor as ``<path>.q.data``, ``.q.scales``, ``.q.zeros``; bf16 leaves as
their uint16 bits) and the HF ``config.json``.  Written and read with the
numpy safetensors code of ``models/loader.py``.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch

from ipex_llm_tpu_torch.device import resolve_device
from ipex_llm_tpu_torch.models.loader import SafetensorsFile, save_safetensors
from ipex_llm_tpu_torch.quantize.core import QTensor

CONFIG_NAME = "bigdl_config.json"  # the reference's file name
WEIGHTS_NAME = "model_low_bit.safetensors"
FORMAT_VERSION = 1


def _walk(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        p = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _walk(v, p + ".")
        else:
            yield p, v


def flatten_params(params: dict) -> tuple[dict[str, torch.Tensor],
                                          dict[str, Any]]:
    """-> (name -> CPU tensor for the safetensors file, manifest)."""
    tensors: dict[str, torch.Tensor] = {}
    manifest: dict[str, Any] = {"qtensors": {}, "scalars": {},
                                "version": FORMAT_VERSION}
    for path, v in _walk(params):
        if isinstance(v, QTensor):
            for key, plane in (("data", v.data), ("scales", v.scales),
                               ("zeros", v.zeros)):
                if plane is not None:
                    tensors[f"{path}.q.{key}"] = plane.cpu()
            manifest["qtensors"][path] = {"qtype": v.qtype,
                                          "shape": list(v.shape),
                                          "block_size": v.block_size}
        elif isinstance(v, (float, int)):
            manifest["scalars"][path] = v
        elif v.dtype == torch.bfloat16:
            tensors[path] = v.cpu().view(torch.uint16)
            manifest.setdefault("bf16", []).append(path)
        else:
            tensors[path] = v.cpu()
    return tensors, manifest


def unflatten_params(tensors: dict[str, torch.Tensor],
                     manifest: dict[str, Any], device=None) -> dict:
    """The tree ``flatten_params`` flattened, its tensors on ``device``
    (``None`` = cuda)."""
    dev = resolve_device(device)
    params: dict[str, Any] = {}

    def put(path: str, v: Any):
        parts = path.split(".")
        d = params
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v

    bf16 = set(manifest.get("bf16", []))
    for base, meta in manifest["qtensors"].items():
        def plane(key):
            t = tensors.get(f"{base}.q.{key}")
            return None if t is None else t.to(dev)
        put(base, QTensor(plane("data"), plane("scales"), plane("zeros"),
                          meta["qtype"], tuple(meta["shape"]),
                          int(meta["block_size"])))
    for name, t in tensors.items():
        if ".q." in name and name.rsplit(".q.", 1)[0] in manifest["qtensors"]:
            continue
        put(name, (t.view(torch.bfloat16) if name in bf16 else t).to(dev))
    for path, v in manifest["scalars"].items():
        put(path, v)
    return params


def save_low_bit(path: str, params: dict, hf_config: dict,
                 qtype: str) -> None:
    os.makedirs(path, exist_ok=True)
    tensors, manifest = flatten_params(params)
    save_safetensors(tensors, os.path.join(path, WEIGHTS_NAME),
                     metadata={"format": "np"})
    with open(os.path.join(path, CONFIG_NAME), "w") as f:
        json.dump({"load_in_low_bit": qtype, "manifest": manifest}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f)


def load_low_bit(path: str, device=None) -> tuple[dict, dict, str]:
    """-> (params on ``device``, hf_config, qtype)."""
    with open(os.path.join(path, CONFIG_NAME)) as f:
        meta = json.load(f)
    with open(os.path.join(path, "config.json")) as f:
        hf_config = json.load(f)
    st = SafetensorsFile(os.path.join(path, WEIGHTS_NAME))
    tensors = {name: st.get(name) for name in st.keys()}
    params = unflatten_params(tensors, meta["manifest"], device)
    return params, hf_config, meta["load_in_low_bit"]
