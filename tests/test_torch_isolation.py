"""The port stands alone: it imports neither JAX nor the JAX package, and
its CUDA entry points refuse to run on a machine without a card instead of
carrying on on the CPU."""

import ast
import pathlib
import subprocess
import sys
import textwrap

import pytest
import torch

from ipex_llm_tpu_torch import resolve_device
from ipex_llm_tpu_torch.models.random_init import llama_config, random_params

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ipex_llm_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "ipex_llm_tpu")


def test_port_imports_without_jax_or_the_reference():
    """Every module of the package imports with ``jax`` poisoned in
    ``sys.modules``, and afterwards no module of the JAX package is
    loaded."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["jaxlib"] = None
        import ipex_llm_tpu_torch as pkg
        names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                       pkg.__name__ + ".")]
        for name in names:
            importlib.import_module(name)
        bad = [m for m in sys.modules
               if m == "ipex_llm_tpu" or m.startswith("ipex_llm_tpu.")]
        assert not bad, bad
        print(" ".join(sorted(names)))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    on_disk = {".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in PORT.rglob("*.py")}
    on_disk = {n[: -len(".__init__")] if n.endswith(".__init__") else n
               for n in on_disk} - {"ipex_llm_tpu_torch"}
    assert set(out.stdout.split()) == on_disk
    # expert offload and its LRU, which the reference keeps beside JAX
    # code, are among them
    assert {"ipex_llm_tpu_torch.offload",
            "ipex_llm_tpu_torch.hostutil"} <= on_disk


def test_port_imports_without_safetensors_or_transformers():
    """The card's machine has neither package: every module of the port
    imports with both poisoned in ``sys.modules`` (the loader parses
    safetensors with numpy; ``build_server`` imports ``transformers`` only
    when it is given no tokenizer)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        for name in ("safetensors", "transformers", "jax", "jaxlib"):
            sys.modules[name] = None
        import ipex_llm_tpu_torch as pkg
        for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(m.name)
        from ipex_llm_tpu_torch.transformers import AutoModelForCausalLM
        from ipex_llm_tpu_torch.optimize import optimize_model
        from ipex_llm_tpu_torch.serving.api_server import build_server, main
        loaded = [m for m in sys.modules if m.split(".")[0] in (
            "safetensors", "transformers") and sys.modules[m] is not None]
        assert not loaded, loaded
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PORT.rglob("*.py")]
    + [p.relative_to(ROOT).as_posix()
       for p in (ROOT / "scripts").glob("torch_*.py")]
    + ["chip_smoke.py"]))
def test_no_jax_or_reference_import_in_source(path):
    """No module of the port, no card script (``scripts/torch_*.py``,
    which the card's machine runs without JAX) and not ``chip_smoke.py``
    imports JAX or the JAX package."""
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_cuda_entry_points_raise_without_a_card():
    """The default device is the card; with none present every entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = llama_config(hidden_size=32, intermediate_size=64, num_layers=1,
                       num_heads=2, num_kv_heads=2, vocab_size=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        random_params(cfg, device="cuda")
    from ipex_llm_tpu_torch.serving.engine import ServingEngine

    params = random_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, params)
