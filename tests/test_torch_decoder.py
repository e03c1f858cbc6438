"""The port's decoder against the JAX ``decoder_forward`` over the paged
pool: a ragged prefill (per-row ``chunk_lens`` and ``gather_positions``)
followed by three T=1 decode steps, for bf16 and sym_int4 weights over
bf16 and fp8 (e5m2) pools.  Each side keeps its own pool, so a decode
step attends to the K/V that side wrote."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.kv import PagedKVCache as RefPagedKVCache
from ipex_llm_tpu.models.decoder import decoder_forward as ref_forward
from ipex_llm_tpu.ops.rope import RopeScaling
from ipex_llm_tpu_torch.kv import PagedKVCache
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.convert import params_from_reference
from ipex_llm_tpu_torch.models.decoder import decoder_forward
from tests.test_decoder import rand_params, tiny_cfg
from tests.test_torch_quantize import reference_tree


def tiny_pair(qtype: str, **widths):
    """(reference cfg, reference params, port cfg, port params): 2 layers,
    hidden 64, 4 heads over 2 kv heads (GQA), head_dim 16, vocab 256, or
    the ``tiny_cfg`` widths given."""
    kw = {**dict(vocab_size=256, hidden_size=64, intermediate_size=160,
                 num_heads=4, num_kv_heads=2, head_dim=16,
                 max_position_embeddings=512), **widths}
    cfg = tiny_cfg(rope=RopeScaling(head_dim=kw["head_dim"]), **kw)
    params = rand_params(cfg, qtype=qtype)
    port_cfg = ModelConfig.from_fields(dataclasses.asdict(cfg))
    return cfg, params, port_cfg, params_from_reference(
        reference_tree(params), device="cpu")


def test_config_outside_the_slice_raises():
    """Fields of families still to port raise (windows, softcaps and the
    qkv bias are in the slice since the qwen2 and gemma2 families, q/k
    norms and experts since qwen3 and the MoE families, the gemma family
    and partial rotary, here a rope table narrower than head_dim, since
    phi3 and gemma, DeepSeek's routing, routed scaling factor and
    interleaved rope layout since the deepseek families, LayerNorm, the
    MLP's and o's biases, the ungated MLP and the parallel residual since
    the GPT-style families, the muP scalings since minicpm, olmo2's
    reordered norms since olmo2, cohere and falcon since their rows);
    other families, rope layouts, norms and the fields of other blocks
    still raise)."""
    cfg = tiny_cfg()
    fields = dataclasses.asdict(cfg)
    for over in ({"embed_norm": True}, {"alibi": True},
                 {"model_type": "bloom"}, {"rope_layout": "neox"},
                 {"norm_kind": "group"}, {"glm_alpha": 2.0}):
        with pytest.raises(NotImplementedError):
            ModelConfig.from_fields({**fields, **over})
    for over in ({"sliding_window": 64}, {"attn_softcap": 30.0},
                 {"attention_bias": True}, {"qk_norm": True},
                 {"num_experts": 4, "num_experts_per_tok": 2,
                  "moe_intermediate_size": 32},
                 {"model_type": "gemma"}, {"head_dim": 16},
                 {"moe_n_group": 4}, {"moe_score_func": "sigmoid"},
                 {"moe_router_scale": 2.5},
                 {"model_type": "deepseek_v2"}, {"rope_layout": "two"},
                 {"mlp_bias": True}, {"attention_out_bias": True},
                 {"norm_kind": "layer"}, {"mlp_gated": False},
                 {"parallel_blocks": True}, {"model_type": "gptj"},
                 {"model_type": "minicpm"}, {"residual_multiplier": 0.25},
                 {"logit_scale": 0.125}, {"norm_after": True},
                 {"model_type": "cohere"}, {"model_type": "falcon"}):
        assert ModelConfig.from_fields({**fields, **over})


@pytest.mark.parametrize("qtype", ["bf16", "sym_int4"])
@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_decoder_forward_matches_reference(qtype, storage):
    """Logits agree within a bf16 tolerance.  Both sides round at the same
    points (bf16 activations, fp32 norms and rope, bf16 linear outputs);
    they differ in summation order and width (the port's plain versions
    sum in float64), which moves individual bf16 activations by one ulp.
    Through two layers that stays under 1% of the logit range (measured
    0.8%); the bound is 2.5%, with a mean under 0.5%.  An e5m2 pool keeps
    2 mantissa bits, so a one-ulp bf16 difference in k or v before the
    encode can move a stored code by a whole e5m2 step (measured 3.1% of
    the range at worst, 0.45% on average): bounds 6% and 1%."""
    cfg, params, port_cfg, port_params = tiny_pair(qtype)
    ps, maxp, r, t = 16, 4, 3, 24
    n_pages = 1 + r * maxp
    tables = (1 + np.arange(r * maxp, dtype=np.int32)).reshape(r, maxp)
    ref_cache = RefPagedKVCache.init(
        cfg.num_layers, n_pages, r, maxp, cfg.num_kv_heads, ps,
        cfg.head_dim, storage=storage).with_tables(jnp.asarray(tables))
    cache = PagedKVCache.init(port_cfg.num_layers, n_pages, r, maxp,
                              port_cfg.num_kv_heads, ps, port_cfg.head_dim,
                              storage=storage, device="cpu")
    cache.tables.copy_(torch.from_numpy(tables))

    rng = np.random.default_rng(17)
    chunk = np.array([24, 9, 17], np.int32)
    base = np.zeros(r, np.int32)
    toks = rng.integers(0, cfg.vocab_size, (r, t)).astype(np.int32)
    pos = base[:, None] + np.arange(t, dtype=np.int32)[None, :]
    steps = [dict(tokens=toks, pos=pos, base=base, chunk=chunk,
                  gather=chunk - 1)]
    lens = base + chunk
    for _ in range(3):
        steps.append(dict(
            tokens=rng.integers(0, cfg.vocab_size, (r, 1)).astype(np.int32),
            pos=lens[:, None].copy(), base=lens.copy(), chunk=None,
            gather=None))
        lens = lens + 1

    for i, s in enumerate(steps):
        kw = dict(slot_offsets=s["base"])
        if s["chunk"] is not None:
            kw.update(chunk_lens=s["chunk"], gather_positions=s["gather"])
        else:
            kw.update(last_token_only=True)
        want, ref_cache = ref_forward(
            cfg, params, jnp.asarray(s["tokens"]), ref_cache,
            jnp.asarray(s["pos"]),
            **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        got, cache = decoder_forward(
            port_cfg, port_params, torch.from_numpy(s["tokens"]), cache,
            torch.from_numpy(s["pos"]),
            **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
               for k, v in kw.items()})
        want = np.asarray(want)
        assert got.dtype == torch.float32 and got.shape == want.shape == (
            r, cfg.vocab_size), i
        span = want.max() - want.min()
        max_tol, mean_tol = (0.025, 0.005) if storage == "bf16" else (
            0.06, 0.01)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=max_tol * span, err_msg=f"step {i}")
        assert np.abs(got.numpy() - want).mean() <= mean_tol * span, i
        assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() >= 2 / 3
