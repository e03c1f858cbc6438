"""The port's decoder over the MiniCPM families of
``tests/test_torch_minicpm.py``'s tiny checkpoints against the JAX
``decoder_forward`` on the reference's tree carried across: a ragged
paged prefill and three decode steps over bf16 and e5m2 pools (B1's plain
version at (64, 64) and (96, 64)), and a left-padded dense prefill (B4's
and B3's plain versions); on the dense form each muP scaling moves the
logits when set to 1.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.kv import PagedKVCache as RefPagedKVCache
from ipex_llm_tpu.kv import make_cache as ref_make_cache
from ipex_llm_tpu.models.decoder import decoder_forward as ref_forward
from ipex_llm_tpu_torch.kv import PagedKVCache, make_cache
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from tests.test_torch_families import _close
from tests.test_torch_families_phi_gemma import _run
from tests.test_torch_minicpm import ckpt, loaded  # noqa: F401 (fixtures)
from tests.test_torch_quantize import reference_tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (the tiny models' many
    small ops run fastest on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _caches(form, cfg, storage):
    """(reference cache, a maker of the port's) with V at its own width."""
    ps, maxp, r = 16, 4, 3
    if form == "paged":
        tables = (1 + np.arange(r * maxp, dtype=np.int32)).reshape(r, maxp)
        ref = RefPagedKVCache.init(
            cfg.num_layers, 1 + r * maxp, r, maxp, cfg.num_kv_heads, ps,
            cfg.head_dim, v_head_dim=cfg.v_dim,
            storage=storage).with_tables(jnp.asarray(tables))

        def port():
            c = PagedKVCache.init(cfg.num_layers, 1 + r * maxp, r, maxp,
                                  cfg.num_kv_heads, ps, cfg.head_dim,
                                  storage=storage, device="cpu",
                                  v_head_dim=cfg.v_dim)
            c.tables.copy_(torch.from_numpy(tables))
            return c
        return ref, port
    kind = "normal" if storage == "bf16" else "fp8"
    return (ref_make_cache(kind, cfg.num_layers, 3, 48, cfg.num_kv_heads,
                           cfg.head_dim, v_head_dim=cfg.v_dim),
            lambda: make_cache(kind, cfg.num_layers, 3, 48, cfg.num_kv_heads,
                               cfg.head_dim, v_head_dim=cfg.v_dim,
                               device="cpu"))


@pytest.mark.parametrize("form,storage", [("paged", "bf16"),
                                          ("paged", "fp8"),
                                          ("dense", "bf16")])
def test_decoder_matches_reference(loaded, form, storage):
    """The port's decoder on the reference's tree carried across against
    ``decoder_forward`` (a ragged paged prefill and three decode steps, or
    a left-padded dense one), within the decoder tests' bounds.  On the
    dense form each scaling moves the logits when set to 1."""
    ref, _ = loaded
    cfg, params = ref.config, ref.params
    port_cfg = ModelConfig.from_fields(dataclasses.asdict(cfg))
    port_params = params_from_reference(reference_tree(params), device="cpu")
    ref_cache, port_cache = _caches(form, cfg, storage)
    want = _run(form, cfg, params, ref_forward, jnp.asarray, storage,
                ref_cache)
    got = _run(form, port_cfg, port_params, decoder_forward,
               torch.from_numpy, storage, port_cache())
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, storage, f"step {i}")
    if form != "dense":
        return
    for field in ("embedding_multiplier", "residual_multiplier",
                  "logit_scale"):
        moved = _run(form, dataclasses.replace(port_cfg, **{field: 1.0}),
                     port_params, decoder_forward, torch.from_numpy,
                     storage, port_cache())
        assert max(float((m - g).abs().max()) for m, g in zip(moved, got)) \
            > 0.05, field
