"""Tensor parallelism's per-rank pieces (``ipex_llm_tpu_torch/parallel/``)
and the five sharded kernel wrappers against the JAX package's.

- ``_block_perm``, ``relayout_packed``, ``local_cfg``, ``ineligible_reason``,
  ``tp_mode`` and the per-rank slices of ``shard_params_manual`` are
  bitwise the reference's: the JAX side's slices are the
  ``addressable_shards`` of its placed tree on the conftest's 8-device CPU
  mesh, device r holding rank r's.
- Each sharded wrapper (B1s, B2s col, B3s, B4s, B5s prefill and decode),
  run rank by rank on the CPU (its plain version) with the outputs
  concatenated over the heads, matches the reference's ``_sharded``
  wrapper on the same numpy inputs (its Pallas kernel interpreted, as the
  JAX package's own tests run it) within the kernel tests' tolerance, one
  bf16 ulp of each row's largest output, at tp = 2 and 4, with the GQA
  repeat (2 kv heads at tp = 4 and 8) where the reference has it; and the
  concatenation is bitwise the unsharded plain version (every head is
  computed alone, in float64).  B2s row needs a group:
  ``tests/test_torch_collectives.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from ipex_llm_tpu.ops.pallas.decode_attention import \
    decode_sdpa_sharded as ref_decode_sharded
from ipex_llm_tpu.ops.pallas.flash_attention import \
    flash_sdpa_sharded as ref_flash_sharded
from ipex_llm_tpu.ops.pallas.paged_attention import (
    paged_decode_sdpa_sharded as ref_paged_decode_sharded,
    paged_prefill_sdpa_sharded as ref_paged_prefill_sharded)
from ipex_llm_tpu.ops.pallas.qmatmul import qmatmul_pallas_sharded
from ipex_llm_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_sdpa_sharded as ref_ragged_sharded
from ipex_llm_tpu.parallel import MeshSpec as RefMeshSpec
from ipex_llm_tpu.parallel import make_mesh
from ipex_llm_tpu.parallel import manual as ref_manual
from ipex_llm_tpu.parallel.shard import _qtensor_spec
from ipex_llm_tpu.quantize import core as ref_core
from ipex_llm_tpu.quantize.core import QTensor as RefQTensor
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.parallel import manual, shard
from ipex_llm_tpu_torch.parallel.mesh import MeshSpec, rank_device
from ipex_llm_tpu_torch.quantize.core import QTensor
from tests.test_torch_attention_dense import _pair
from tests.test_torch_decoder import tiny_pair
from tests.test_torch_ops import _bf16, _f32, _port_qtensor
from tests.test_torch_paged_attention import _pool

ULP = 2.0 ** -7


def tp_mesh(tp: int) -> Mesh:
    """The conftest's first ``tp`` CPU devices on the one axis "tp" (the
    reference's wrappers leave ``make_mesh``'s other axes to GSPMD, which
    this jax refuses in their out_specs)."""
    return Mesh(np.asarray(jax.devices()[:tp]), ("tp",))


def _heads(x: torch.Tensor, axis: int, tp: int, rank: int) -> torch.Tensor:
    n = x.shape[axis] // tp
    return x.narrow(axis, rank * n, n).contiguous()


def _rows_close(got, want):
    """Per leading row: max |got - want| within one bf16 ulp of the row's
    largest |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    axes = tuple(range(1, got.ndim))
    err = np.abs(got - want).max(axis=axes)
    top = np.abs(want).max(axis=axes)
    assert (err <= ULP * top).all(), (err, top)


# -- the per-rank layout, bitwise the reference's ------------------------------

@pytest.mark.parametrize("sections,tp", [((12, 4, 4), 2), ((12, 4, 4), 4),
                                         ((48, 48), 8), ((8, 16, 16), 4)])
def test_block_perm_is_the_reference(sections, tp):
    np.testing.assert_array_equal(manual._block_perm(sections, tp),
                                  ref_manual._block_perm(sections, tp))


@pytest.fixture(scope="module", params=["bf16", "sym_int4", "asym_int4"])
def pair(request):
    """The tiny decoder of tests/test_torch_decoder (4 q heads over 2 kv
    heads) at widths whose planes split at tp = 2 in whole blocks."""
    return tiny_pair(request.param, hidden_size=128, head_dim=32,
                     intermediate_size=256)


def _np_leaf(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


def _leaves(tree, prefix=""):
    """(path, numpy leaf) of a param tree, QTensor planes by name."""
    for k, v in sorted(tree.items()):
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + ".")
        elif isinstance(v, (QTensor, RefQTensor)):
            for plane in ("data", "scales", "zeros"):
                if getattr(v, plane) is not None:
                    yield f"{path}.{plane}", getattr(v, plane)
        elif v is not None and not isinstance(v, (float, int)):
            yield path, v


def test_relayout_and_local_cfg_are_the_reference(pair):
    """The packed projections' column permutation at tp = 2, plane for
    plane, and the rank-local head counts."""
    cfg, params, port_cfg, port_params = pair
    want = dict(_leaves(ref_manual.relayout_packed(params, cfg, 2)))
    got = dict(_leaves(manual.relayout_packed(port_params, port_cfg, 2)))
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(_np_leaf(got[k]), _np_leaf(want[k]),
                                      err_msg=k)
    lc, rlc = manual.local_cfg(port_cfg, 2), ref_manual.local_cfg(cfg, 2)
    assert (lc.num_heads, lc.num_kv_heads) == (rlc.num_heads,
                                               rlc.num_kv_heads) == (2, 1)
    assert manual.local_cfg(port_cfg, 1) is port_cfg


def test_shard_params_manual_is_the_references_shards(pair):
    """Each rank's slices are bitwise the reference's placed shards on
    device ``rank`` (col, row and replicated leaves; the lm head's
    vocabulary split)."""
    cfg, params, port_cfg, port_params = pair
    tp = 2
    mesh = tp_mesh(tp)
    placed = dict(_leaves(ref_manual.shard_params_manual(params, cfg, mesh)))
    for rank in range(tp):
        mine = dict(_leaves(manual.shard_params_manual(
            port_params, port_cfg, tp, rank)))
        assert mine.keys() == placed.keys()
        dev = mesh.devices.flat[rank]
        for k, arr in placed.items():
            want = next(s.data for s in arr.addressable_shards
                        if s.device == dev)
            np.testing.assert_array_equal(_np_leaf(mine[k]),
                                          _np_leaf(want), err_msg=k)


def test_ineligible_reason_is_the_reference(pair):
    """The same answer, word for word, on an eligible tree, without a tp
    axis, on a composed mesh, with the sequential engine, with heads that
    do not divide, with MoE stacks and with a 5-bit row weight; MeshSpec
    refuses every axis but tp (ROADMAP item 15)."""
    cfg, params, port_cfg, port_params = pair
    cases = [(tp_mesh(2), 128), (tp_mesh(1), 128),
             (make_mesh(RefMeshSpec(dp=2, tp=2)), 128), (tp_mesh(2), 0),
             (tp_mesh(8), 128)]
    for mesh, budget in cases:
        want = ref_manual.ineligible_reason(cfg, params, mesh, budget)
        got = manual.ineligible_reason(port_cfg, port_params,
                                       dict(mesh.shape), budget)
        assert got == want
    assert manual.ineligible_reason(port_cfg, port_params, {"tp": 2},
                                    128) is None
    moe = {"layers": {"moe_gate_up": None}}
    assert manual.ineligible_reason(port_cfg, moe, {"tp": 2}, 128) == \
        ref_manual.ineligible_reason(cfg, moe, tp_mesh(2), 128)
    w = np.random.default_rng(3).standard_normal((64, 64)).astype(
        np.float32)
    rq = ref_core.quantize(jnp.asarray(w), "sym_int5")
    ref_tree = {"layers": {**params["layers"], "o": rq}}
    port_tree = {"layers": {**port_params["layers"], "o": QTensor(
        *(None if p is None else torch.from_numpy(np.asarray(p).copy())
          for p in (rq.data, rq.scales, rq.zeros)),
        rq.qtype, tuple(rq.shape), rq.block_size)}}
    assert manual.ineligible_reason(port_cfg, port_tree, {"tp": 2}, 128) \
        == ref_manual.ineligible_reason(cfg, ref_tree, tp_mesh(2), 128) \
        == "o does not row-shard at tp=2 (shape/blocks do not divide)"
    with pytest.raises(NotImplementedError, match="item 15"):
        MeshSpec(dp=2, tp=2)
    assert MeshSpec(tp=4).axis_sizes()["tp"] == 4


@pytest.mark.parametrize("qtype", ["sym_int4", "asym_int4", "nf4",
                                   "sym_int5", "sym_int8", "fp6",
                                   "fp8_e4m3"])
@pytest.mark.parametrize("k", [256, 200])
def test_tp_mode_is_the_reference(qtype, k):
    """col, row or None as ``_qtensor_spec`` stamps it at tp = 2, 4, 8:
    row needs whole blocks a rank and no padded tail, and never 5-bit."""
    w = np.random.default_rng(k).standard_normal((k, 64)).astype(np.float32)
    rq = ref_core.quantize(jnp.asarray(w), qtype)
    qt = _port_qtensor(rq)
    for tp in (2, 4, 8):
        for kind in ("col", "row", "rep"):
            assert shard.tp_mode(qt, kind, tp) == _qtensor_spec(
                rq, kind, tp, stacked=False)[1], (tp, kind)


def test_nccl_is_refused_without_a_card_a_rank():
    """nccl with two ranks on one card (or on the CPU) raises and is never
    swapped for gloo; gloo runs wherever it is named."""
    for device in (None, "cuda:0", "cpu"):
        with pytest.raises(ValueError, match="gloo"):
            rank_device("nccl", 1, 2, device)
    with pytest.raises(ValueError, match="gloo"):
        rank_device("nccl", 0, 2, "cuda:0")
    assert rank_device("gloo", 1, 2, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        rank_device("mpi", 0, 2, "cpu")


# -- the sharded wrappers against the reference's -------------------------------

def _ragged_args(hq, hkv, storage="bf16"):
    """B1's row mix (tests/test_torch_ops.py::_ragged_case) at ``hq`` /
    ``hkv`` heads: (jax args, torch args)."""
    from tests.test_torch_ops import _ragged_case
    dt = jnp.bfloat16 if storage == "bf16" else jnp.float8_e5m2
    jax_args, torch_args, _ = _ragged_case(dt, hq=hq, hkv=hkv)
    return jax_args, torch_args


HEADS = [(2, 4, 2), (4, 8, 4), (4, 8, 2), (8, 8, 2)]   # (tp, Hq, Hkv)


def _rank_pool(pool, hkv, tp, rank, axis=1):
    """What a rank holds of a pool: its kv heads where they divide, all of
    them where the reference repeats them."""
    return _heads(pool, axis, tp, rank) if hkv % tp == 0 else pool


@pytest.mark.parametrize("tp,hq,hkv,storage", [
    h + ("bf16",) for h in HEADS] + [(4, 8, 2, "e5m2")])
def test_ragged_sharded_matches_reference(tp, hq, hkv, storage):
    jax_args, (q, k, v, tables, kv_len, chunk) = _ragged_args(hq, hkv,
                                                              storage)
    want = ref_ragged_sharded(*jax_args[:5], tp_mesh(tp),
                              chunk_len=jax_args[5])
    b1.SHARDED.reset()
    got = torch.cat([b1.ragged_paged_sdpa_sharded(
        _heads(q, 2, tp, r), _rank_pool(k, hkv, tp, r),
        _rank_pool(v, hkv, tp, r), tables, kv_len, chunk, tp=tp, rank=r,
        n_kv_heads=hkv) for r in range(tp)], dim=2)
    assert b1.SHARDED.plain_calls == tp and b1.SHARDED.launches == 0
    keep = chunk.numpy() > 0
    _rows_close(got[keep], np.asarray(_f32(want))[keep])
    assert torch.equal(got, b1.ragged_paged_sdpa(q, k, v, tables, kv_len,
                                                 chunk))


@pytest.mark.parametrize("tp,hq,hkv", HEADS)
def test_paged_sharded_matches_reference(tp, hq, hkv):
    """B5s, prefill (C = 8) and decode, in both regimes."""
    rng = np.random.default_rng(35 + tp)
    r, d, ps, maxp = 4, 16, 16, 4
    n_pages = 1 + r * maxp
    kv_len = np.asarray([9, 40, 64, 17], np.int32)
    tables = (1 + rng.permutation(r * maxp)).astype(np.int32).reshape(r,
                                                                      maxp)
    kj, kt = _pool(rng, (n_pages, hkv, ps, d), "bf16")
    vj, vt = _pool(rng, (n_pages, hkv, ps, d), "bf16")
    for c, ref_fn, port_fn, counts in (
            (8, ref_paged_prefill_sharded, b5.paged_prefill_sdpa_sharded,
             b5.SHARDED_PREFILL),
            (1, ref_paged_decode_sharded, b5.paged_decode_sdpa_sharded,
             b5.SHARDED_DECODE)):
        qj, qt = _bf16(rng.standard_normal((r, c, hq, d)))
        want = ref_fn(qj, kj, vj, jnp.asarray(tables), jnp.asarray(kv_len),
                      tp_mesh(tp))
        counts.reset()
        got = torch.cat([port_fn(
            _heads(qt, 2, tp, i), _rank_pool(kt, hkv, tp, i),
            _rank_pool(vt, hkv, tp, i), torch.from_numpy(tables),
            torch.from_numpy(kv_len), tp=tp, rank=i, n_kv_heads=hkv)
            for i in range(tp)], dim=2)
        assert counts.plain_calls == tp
        _rows_close(got, want)
        unsharded = (b5.paged_prefill_sdpa if c > 1
                     else b5.paged_decode_sdpa)
        assert torch.equal(got, unsharded(qt, kt, vt,
                                          torch.from_numpy(tables),
                                          torch.from_numpy(kv_len)))


@pytest.mark.parametrize("tp,hq,hkv", [(2, 8, 2), (4, 8, 4), (4, 8, 2)])
def test_decode_sharded_matches_reference(tp, hq, hkv):
    """B3s over a head-major cache layer with left padding and ragged fill,
    at head_dim 128 (the reference kernel's), a window on."""
    rng = np.random.default_rng(5)
    b, s, d = 3, 256, 128
    q_t, q_j = _pair(rng, (b, 1, hq, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d))
    v_t, v_j = _pair(rng, (b, hkv, s, d))
    kw = dict(kv_len=np.array([200, 256, 91], np.int32),
              kv_start=np.array([0, 37, 30], np.int32), window=96)
    want = ref_decode_sharded(q_j, k_j, v_j, tp_mesh(tp),
                              **{k: jnp.asarray(v) if isinstance(
                                  v, np.ndarray) else v
                                 for k, v in kw.items()})
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    b3.SHARDED.reset()
    got = torch.cat([b3.decode_sdpa_sharded(
        _heads(q_t, 2, tp, r), _rank_pool(k_t, hkv, tp, r),
        _rank_pool(v_t, hkv, tp, r), tp=tp, rank=r, n_kv_heads=hkv, **tkw)
        for r in range(tp)], dim=2)
    assert b3.SHARDED.plain_calls == tp
    _rows_close(got, want)
    assert torch.equal(got, b3.decode_sdpa(q_t, k_t, v_t, **tkw))


@pytest.mark.parametrize("tp,hq,hkv", [(2, 8, 2), (4, 8, 4)])
def test_flash_sharded_matches_reference(tp, hq, hkv):
    """B4s, causal prefill rows with left padding, at head_dim 128; both
    head counts must divide tp (the reference repeats no kv head here)."""
    rng = np.random.default_rng(7)
    b, t, d = 2, 80, 128
    q_t, q_j = _pair(rng, (b, t, hq, d))
    k_t, k_j = _pair(rng, (b, t, hkv, d))
    v_t, v_j = _pair(rng, (b, t, hkv, d))
    ks = np.array([0, 30], np.int32)
    want = ref_flash_sharded(q_j, k_j, v_j, tp_mesh(tp),
                             kv_start=jnp.asarray(ks))
    b4.SHARDED.reset()
    got = torch.cat([b4.flash_sdpa_sharded(
        _heads(q_t, 2, tp, r), _heads(k_t, 2, tp, r), _heads(v_t, 2, tp, r),
        tp=tp, n_kv_heads=hkv, kv_start=torch.from_numpy(ks))
        for r in range(tp)], dim=2)
    assert b4.SHARDED.plain_calls == tp
    rows = got.shape[0] * got.shape[1]
    _rows_close(got.reshape(rows, hq, d),
                _f32(want).reshape(rows, hq, d))
    assert torch.equal(got, b4.flash_sdpa(q_t, k_t, v_t,
                                          kv_start=torch.from_numpy(ks)))
    with pytest.raises(NotImplementedError):
        b4.flash_sdpa_sharded(q_t[:, :, :1], k_t[:, :, :1], v_t[:, :, :1],
                              tp=8, n_kv_heads=2)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("qtype", ["sym_int4", "nf4", "sym_int8"])
def test_qmatmul_col_matches_reference(tp, qtype):
    """B2s col: each rank's output columns, concatenated, match the
    reference's column-parallel form and are bitwise B2's unsharded plain
    version."""
    rng = np.random.default_rng(tp + len(qtype))
    k, n, m = 256, 192, 5
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    xj, xt = _bf16(rng.standard_normal((m, k)))
    rq = ref_core.quantize(jnp.asarray(w), qtype)
    want = qmatmul_pallas_sharded(xj, dataclasses.replace(rq, tp_mode="col"),
                                  tp_mesh(tp))
    qt = _port_qtensor(rq)
    b2.SHARDED_COL.reset()
    got = torch.cat([b2.qmatmul_sharded(xt, shard.shard_qtensor(
        qt, "col", tp, r), "col") for r in range(tp)], dim=1)
    assert b2.SHARDED_COL.plain_calls == tp
    _rows_close(got, want)
    assert torch.equal(got, b2.qmatmul(xt, qt))


def test_kv_head_slice_and_pool_split():
    """The heads a rank reads: its share where they divide, the reference's
    repeat rule otherwise, and other factorisations refused; ``rank_kv``
    passes a rank's share through, slices its one head out of the whole
    pool and refuses other head counts; the pool's head split keeps the
    shared tables."""
    assert shard.kv_head_slice(8, 4, 2, 1) == (2, 2)
    assert [shard.kv_head_slice(8, 2, 4, r) for r in range(4)] == [
        (0, 1), (0, 1), (1, 1), (1, 1)]
    assert [shard.kv_head_slice(8, 2, 8, r)[0] for r in range(8)] == [
        0, 0, 0, 0, 1, 1, 1, 1]
    for hq, hkv, tp in ((6, 2, 4), (8, 3, 2), (4, 2, 8)):
        with pytest.raises(NotImplementedError):
            shard.kv_head_slice(hq, hkv, tp, 0)
    k, v = torch.randn(3, 2, 5, 4), torch.randn(3, 2, 5, 4)
    mine = shard.rank_kv(k, v, 2, 4, 3, 2)
    assert all(torch.equal(x, y[:, 1:2]) for x, y in zip(mine, (k, v)))
    share = (k[:, :1], v[:, :1])
    got = shard.rank_kv(*share, 4, 2, 1, 2)
    assert got[0] is share[0] and got[1] is share[1]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    mine = shard.rank_kv(kt, vt, 1, 4, 2, 2, axis=2)
    assert torch.equal(mine[0], kt[:, :, 1:2])
    with pytest.raises(ValueError):
        shard.rank_kv(k, v, 4, 2, 0, 8)
    from ipex_llm_tpu_torch.kv import PagedKVCache
    cache = PagedKVCache.init(2, 5, 3, 4, 4, 8, 16, device="cpu")
    cache.k.normal_()
    part = shard.shard_paged_cache(cache, 2, 1)
    assert torch.equal(part.k, cache.k[:, :, 2:4])
    assert part.tables is cache.tables
    assert shard.shard_paged_cache(cache, 8, 3) is cache
