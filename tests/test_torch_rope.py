"""Rope scaling and partial rotary in the port against the JAX package.

- every scaling kind's ``inv_freq`` and ``mscale`` bitwise the reference
  ``RopeScaling``'s, over a grid of head widths, bases, factors and
  sequence lengths that holds the published parameters of Llama-3.1-8B
  (llama3), Gemma-3-4B (linear 8), Qwen2's long-context configs (yarn 4)
  and Phi-3.5-mini (longrope, lists made from a seed, at full rotary and
  at Phi-4-mini's 0.75), and the reference's departures from HF: the
  table at a fixed length, longrope's mscale of 1 without an
  ``attention_factor``, an unknown kind ("su") unscaled;
- the HF ``rope_scaling`` block read by the port's families as by the
  reference's;
- partial-rotary ``apply_rope_partial`` against the reference decoder's
  split, rotate and concatenate, within one bf16 ulp.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.models.families import get_family as ref_get_family
from ipex_llm_tpu.ops import rope as ref_rope
from ipex_llm_tpu_torch.models.config import ModelConfig
from ipex_llm_tpu_torch.models.families import config_from_hf
from ipex_llm_tpu_torch.models.random_init import (GEMMA3_4B_HF,
                                                   LLAMA31_8B_HF,
                                                   phi35_mini_hf)
from ipex_llm_tpu_torch.ops import rope

_PHI = phi35_mini_hf(seed=5)["rope_scaling"]
_PHI4 = phi35_mini_hf(seed=6, partial_rotary_factor=0.75)["rope_scaling"]

# (label, RopeScaling fields): the published settings first, then a grid
SCALINGS = [
    ("llama3.1-8b", dict(head_dim=128, base=500000.0, kind="llama3",
                         factor=8.0, low_freq_factor=1.0,
                         high_freq_factor=4.0, original_max_position=8192)),
    ("gemma3-4b global", dict(head_dim=256, base=1e6, kind="linear",
                              factor=8.0)),
    ("gemma3-4b local", dict(head_dim=256, base=1e4)),
    ("qwen2 yarn 4", dict(head_dim=128, base=1e6, kind="yarn", factor=4.0,
                          original_max_position=32768)),
    ("phi3.5-mini longrope", dict(
        head_dim=96, kind="longrope", original_max_position=4096,
        short_factor=tuple(_PHI["short_factor"]),
        long_factor=tuple(_PHI["long_factor"]))),
    ("phi4-mini longrope 0.75", dict(
        head_dim=96, kind="longrope", original_max_position=4096,
        partial_rotary_factor=0.75,
        short_factor=tuple(_PHI4["short_factor"]),
        long_factor=tuple(_PHI4["long_factor"]))),
    ("longrope attention_factor", dict(
        head_dim=96, kind="longrope", original_max_position=4096,
        attention_factor=1.19, short_factor=tuple(_PHI["short_factor"]),
        long_factor=tuple(_PHI["long_factor"]))),
    ("longrope without lists (the yarn ramp)", dict(
        head_dim=64, kind="longrope", factor=4.0,
        original_max_position=4096)),
    ("su (unknown kind: unscaled)", dict(head_dim=64, kind="su",
                                         factor=4.0)),
] + [
    (f"{kind} d={d} base={base:g} factor={f} omp={omp} prf={prf}",
     dict(head_dim=d, base=base, kind=kind, factor=f,
          original_max_position=omp, partial_rotary_factor=prf,
          low_freq_factor=1.0 if kind != "llama3" else 2.0,
          high_freq_factor=4.0 if kind != "llama3" else 8.0))
    for kind in ("default", "linear", "dynamic", "llama3", "yarn")
    for d, base, f, omp, prf in ((64, 1e4, 2.0, 2048, 1.0),
                                 (96, 5e5, 8.0, 8192, 0.5),
                                 (256, 1e6, 32.0, 4096, 0.75))
]
SEQ_LENS = (None, 1024, 4096, 8192, 131072)


@pytest.mark.parametrize("label,fields", SCALINGS,
                         ids=[s[0] for s in SCALINGS])
def test_tables_bitwise_reference(label, fields):
    ref = ref_rope.RopeScaling(**fields)
    port = rope.RopeScaling(**fields)
    assert port.rotary_dim == ref.rotary_dim
    for n in SEQ_LENS:
        want, got = ref.inv_freq(n), port.inv_freq(n)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want, err_msg=f"seq_len {n}")
        assert port.mscale(n) == ref.mscale(n)
    if fields.get("kind") == "longrope" and "attention_factor" not in fields:
        assert port.mscale(131072) == 1.0      # not HF's sqrt(1 + ...)


def test_reference_departures_from_hf():
    """dynamic and longrope take the table of the length asked for (the
    model's max_position_embeddings at build time), not the sequence's:
    past the original window the dynamic base stretches and longrope
    switches to the long list even for short sequences."""
    d = rope.RopeScaling(head_dim=64, kind="dynamic", factor=4.0,
                         original_max_position=2048)
    assert np.array_equal(d.inv_freq(2048), d.inv_freq(None))
    assert (d.inv_freq(8192)[1:] < d.inv_freq(2048)[1:]).all()
    lr = rope.RopeScaling(head_dim=96, kind="longrope",
                          original_max_position=4096,
                          short_factor=tuple(_PHI["short_factor"]),
                          long_factor=tuple(_PHI["long_factor"]))
    assert not np.array_equal(lr.inv_freq(131072), lr.inv_freq(4096))


@pytest.mark.parametrize("hf", [
    LLAMA31_8B_HF, GEMMA3_4B_HF, phi35_mini_hf(seed=5),
    phi35_mini_hf(seed=6, partial_rotary_factor=0.75),
    {**LLAMA31_8B_HF, "rope_scaling": {"type": "yarn", "factor": 4.0,
                                       "original_max_position_embeddings":
                                           32768}},
    {**LLAMA31_8B_HF, "rope_scaling": {"rope_type": "dynamic",
                                       "factor": 2.0}},
    {**LLAMA31_8B_HF, "rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                                       "attention_factor": 1.2}},
], ids=["llama3", "gemma3", "phi3.5 longrope", "longrope 0.75", "yarn",
        "dynamic", "yarn attention_factor"])
def test_rope_from_hf_matches_reference_family(hf):
    ref = ref_get_family(hf["model_type"], hf).to_config(hf)
    port = config_from_hf(hf)
    assert port == ModelConfig.from_fields(dataclasses.asdict(ref))
    assert port.rope == rope.RopeScaling(**dataclasses.asdict(ref.rope))
    np.testing.assert_array_equal(
        port.rope.inv_freq(port.max_position_embeddings),
        ref.rope.inv_freq(ref.max_position_embeddings))


@pytest.mark.parametrize("head_dim,prf", [(96, 0.75), (128, 0.5),
                                          (64, 1.0)])
def test_partial_rotary_matches_reference(head_dim, prf):
    """The first ``rotary_dim`` columns rotate ("half" layout over them,
    and the interleaved "two" layout likewise), the rest pass through
    bitwise; a layout the reference does not know raises."""
    rng = np.random.default_rng(head_dim)
    sc = rope.RopeScaling(head_dim=head_dim, partial_rotary_factor=prf)
    rd = sc.rotary_dim
    x = rng.standard_normal((2, 7, 3, head_dim)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    inv = sc.inv_freq()
    pos = rng.integers(0, 3000, (2, 7)).astype(np.int32)
    cj, sj = ref_rope.cos_sin(jnp.asarray(pos), jnp.asarray(inv))
    ct, st = rope.cos_sin(torch.from_numpy(pos), torch.from_numpy(inv))
    want = jnp.concatenate(
        [ref_rope.apply_rope(xj[..., :rd], cj, sj, "half"), xj[..., rd:]],
        axis=-1) if rd < head_dim else ref_rope.apply_rope(xj, cj, sj, "half")
    got = rope.apply_rope_partial(xt, ct, st, rd)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-2)
    assert torch.equal(got[..., rd:], xt[..., rd:])
    want2 = np.asarray(jnp.concatenate(
        [ref_rope.apply_rope(xj[..., :rd], cj, sj, "two"), xj[..., rd:]],
        axis=-1).astype(jnp.float32))
    got2 = rope.apply_rope_partial(xt, ct, st, rd, "two")
    np.testing.assert_allclose(got2.float().numpy(), want2, rtol=2.0 ** -7,
                               atol=1e-2)
    with pytest.raises(NotImplementedError):
        rope.apply_rope_partial(xt, ct, st, rd, "neox")
