"""The port's collectives (``ipex_llm_tpu_torch/ops/collectives.py``) and
B2's row-parallel wrapper against the JAX package's.

The wire codes run in process, bitwise against the reference's.  The
all-reduce, the all-gather and B2s row run over ranks that are spawned
gloo processes on the CPU (``tests/torch_tp_ranks.py``), against the
reference's ``collectives.all_reduce`` and ``qmatmul_pallas_sharded`` under
a JAX ``shard_map`` on the conftest's 8-device CPU mesh: every family
bitwise at tp = 2 (a sum of two fp32 values does not depend on its order)
and within one fp32 ulp of the partials' absolute sum at tp = 4 (gloo and
XLA may add four partials in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from ipex_llm_tpu.ops import collectives as ref_coll
from ipex_llm_tpu.ops.pallas.qmatmul import qmatmul_pallas_sharded
from ipex_llm_tpu.parallel.compat import shard_map
from ipex_llm_tpu.quantize import core as ref_core
from ipex_llm_tpu_torch.ops import collectives
from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from tests import torch_tp_ranks
from tests.test_torch_ops import _bf16, _f32, _port_qtensor

FAMILIES = collectives.ALLREDUCE_QTYPES


def _x(seed=91):
    """[8, 4, 64] fp32 partials with a saturating outlier and a zero
    block, split over the ranks on axis 0."""
    x = np.random.default_rng(seed).standard_normal((8, 4, 64)).astype(
        np.float32)
    x[0, 0, 3] = 9.0e4          # past e5m2's largest finite value
    x[1, 2, :] = 0.0            # an all-zero int8 block
    return x


def tp_mesh(tp: int) -> Mesh:
    """A mesh of the conftest's first ``tp`` CPU devices with the one axis
    "tp" (the reference's wrappers leave other axes of ``make_mesh``'s
    five to GSPMD, which this jax refuses in their out_specs)."""
    return Mesh(np.asarray(jax.devices()[:tp]), ("tp",))


def _ref_reduce(x, tp):
    mesh = tp_mesh(tp)
    out = {}
    for q in FAMILIES:
        fn = jax.jit(shard_map(
            lambda v, q=q: ref_coll.all_reduce(v, "tp", qtype=q),
            mesh=mesh, in_specs=P("tp", None), out_specs=P(),
            axis_names={"tp"}, check_vma=False))
        out[q] = np.asarray(fn(jnp.asarray(x)))
    return out


ROW_CASES = (("sym_int4", 256, 96, 3), ("asym_int4", 256, 64, 8),
             ("sym_int8", 512, 48, 1))


def _row_inputs():
    """(port cases, reference cases) of B2s row: x [M, K] and the weight
    quantized by the reference's codec, in three formats."""
    port, ref = [], []
    for i, (qtype, k, n, m) in enumerate(ROW_CASES):
        rng = np.random.default_rng(40 + i)
        w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
        xj, xt = _bf16(rng.standard_normal((m, k)))
        rq = ref_core.quantize(jnp.asarray(w), qtype)
        port.append((xt, _port_qtensor(rq), qtype))
        ref.append((xj, rq))
    return port, ref


@pytest.fixture(scope="module", params=[2, 4])
def ranks(request, tmp_path_factory):
    """The ranks' results at tp = 2 or 4, with the reference's."""
    tp = request.param
    x = _x()
    port_cases, ref_cases = _row_inputs()
    fams = ("bf16", "e5m2", "int8")
    res = torch_tp_ranks.spawn(
        torch_tp_ranks.collectives_rank, tp,
        tmp_path_factory.mktemp(f"coll{tp}"), x, FAMILIES,
        [(xt, qt, q) for xt, qt, _ in port_cases for q in fams])
    mesh = tp_mesh(tp)
    want_rows = []
    for xj, rq in ref_cases:
        qt = dataclasses.replace(rq, tp_mode="row")
        for q in fams:
            # the reference's kernel sums its partials exactly; a quantized
            # family is the same partials coded, which the port's wrapper
            # reproduces from its own partials
            want_rows.append(_f32(qmatmul_pallas_sharded(xj, qt, mesh))
                             if q == "bf16" else None)
    return tp, x, _ref_reduce(x, tp), res, want_rows


@pytest.mark.parametrize("shape", [(4, 64), (3, 2, 128), (5, 48)])
def test_wire_codes_are_bitwise_the_reference(shape):
    """e5m2 (saturating at 57344) and blockwise int8 (64-wide blocks, or
    the whole axis when 64 does not divide it; fp16 scales saturating at
    65504; an all-zero block) code and decode to the reference's bits."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32) * 3.0
    x.reshape(-1)[0] = 1.0e5
    x.reshape(-1)[1] = -7.0e4
    x.reshape(-1)[-1] = 1.0e10          # amax / 127 past fp16's max
    x[..., :x.shape[-1] // 2][(0,) * (x.ndim - 1)] = 0.0
    for port_fn, ref_fn in ((collectives._e5m2_code, ref_coll._e5m2_code),
                            (collectives._int8_code, ref_coll._int8_code)):
        got = port_fn(torch.from_numpy(x)).numpy()
        want = np.asarray(ref_fn(jnp.asarray(x)))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_resolve_qtype_and_ladder(monkeypatch):
    """The argument, then IPEX_LLM_TPU_COLLECTIVE_QTYPE, then bf16, as the
    reference resolves it; an unknown family raises; the port records no
    measured ladder (the reference's numbers are a CPU mesh's)."""
    monkeypatch.delenv("IPEX_LLM_TPU_COLLECTIVE_QTYPE", raising=False)
    assert collectives.resolve_qtype() == ref_coll.resolve_qtype() == "bf16"
    monkeypatch.setenv("IPEX_LLM_TPU_COLLECTIVE_QTYPE", "int8")
    assert collectives.resolve_qtype() == ref_coll.resolve_qtype() == "int8"
    assert collectives.resolve_qtype("e5m2") == "e5m2"
    with pytest.raises(ValueError):
        collectives.resolve_qtype("fp4")
    with pytest.raises(ValueError):
        collectives.all_reduce(torch.ones(2), None, "fp4")
    assert collectives.ladder() == {}


@pytest.mark.parametrize("family", FAMILIES)
def test_all_reduce_matches_reference(ranks, family):
    """Every rank's sum equals the reference's psum: bitwise at tp = 2,
    within one fp32 ulp of the partials' absolute sum at tp = 4, in each
    wire family; every rank holds the same bits."""
    tp, x, want, res, _ = ranks
    for rank in range(tp):
        got = res[rank][0][family]
        assert got.shape == want[family].shape == (8 // tp, 4, 64)
        if tp == 2:
            np.testing.assert_array_equal(got.view(np.int32),
                                          want[family].view(np.int32))
        else:   # one ulp of the partials' absolute sum: reassociation
            ulp = np.spacing(np.abs(x).reshape(tp, 8 // tp, 4, 64)
                             .sum(axis=0, dtype=np.float32))
            assert (np.abs(got - want[family]) <= ulp).all()
        np.testing.assert_array_equal(got, res[0][0][family])


def test_psum_exact_and_all_gather(ranks):
    """``psum_exact`` of bf16 partials sums in fp32 and rounds once;
    ``all_gather_last`` concatenates the ranks' blocks in rank order,
    exactly; every call is counted; ``bootstrap.health`` reports the
    group alive."""
    tp, x, _, res, _ = ranks
    n = 8 // tp
    parts = [x[r * n:(r + 1) * n] for r in range(tp)]
    bf = [torch.from_numpy(p).to(torch.bfloat16).float().numpy()
          for p in parts]
    want_sum = torch.from_numpy(np.sum(bf, axis=0, dtype=np.float64)
                                .astype(np.float32)).to(torch.bfloat16)
    want_gather = np.concatenate(parts, axis=-1)
    for rank in range(tp):
        out = res[rank][0]
        np.testing.assert_array_equal(out["gather"], want_gather)
        got = torch.from_numpy(out["psum_bf16"])
        assert (got - want_sum.float()).abs().max() <= \
            2.0 ** -7 * want_sum.float().abs().max()
        assert out["calls"] == {"all_reduce": len(FAMILIES) + 1,
                                "all_gather": 1}
        assert out["health"] == {"ok": True, "n_ranks": tp, "rank": rank,
                                 "backend": "gloo"}


def test_qmatmul_row_matches_reference(ranks):
    """B2s row (B2's fp32 partial on each rank's contraction rows, summed
    in fp32 under the wire family, rounded to bf16).  The exact family
    against the reference's ``qmatmul_pallas_sharded`` row form, within
    one bf16 ulp of each row's largest output (the port's partials sum in
    float64, the Pallas kernel's in fp32).  Every family against the
    ranks' own fp32 partials, coded by the reference's wire codes and
    summed here: bitwise at tp = 2, and at tp = 4 within one bf16 ulp of
    the sum plus one fp32 ulp of the coded partials' absolute sum (gloo
    may add four partials in another order).  The e5m2 and int8 outputs
    differ from the exact family's, so the family reaches the sum.  One
    plain call a rank a case."""
    tp, _, _, res, want_rows = ranks
    codes = {"bf16": lambda p: p,
             "e5m2": lambda p: np.asarray(ref_coll._e5m2_code(
                 jnp.asarray(p))),
             "int8": lambda p: np.asarray(ref_coll._int8_code(
                 jnp.asarray(p)))}
    fams = tuple(codes)
    for rank in range(tp):
        outs, _, plain = res[rank][1]
        assert plain == len(outs)
        for i, got in enumerate(outs):
            family = fams[i % 3]
            if family == "bf16":
                exact = want_rows[i]
                tol = 2.0 ** -7 * np.abs(exact).max(axis=1, keepdims=True)
                assert (np.abs(got - exact) <= tol).all()
            else:
                assert not np.array_equal(got, outs[i - i % 3])
            coded = [codes[family](res[r][1][1][i]) for r in range(tp)]
            want = coded[0]
            for c in coded[1:]:
                want = (want + c).astype(np.float32)
            if tp == 2:
                want16 = torch.from_numpy(want).to(torch.bfloat16).float()
                np.testing.assert_array_equal(got, want16.numpy())
            else:
                ulp = np.spacing(np.abs(want)) * 2.0 ** 16 + np.spacing(
                    np.sum(np.abs(coded), axis=0, dtype=np.float32))
                assert (np.abs(got - want) <= ulp).all()
            np.testing.assert_array_equal(got, res[0][1][0][i])


def test_init_distributed_on_one_process(monkeypatch):
    """No group to join on a single process: the reference's and torch's
    environment variables unset or 1."""
    from ipex_llm_tpu_torch.parallel.bootstrap import init_distributed
    for var in ("IPEX_LLM_TPU_NUM_PROCESSES", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() is None
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed() is None
    assert init_distributed(num_processes=1) is None


def test_qmatmul_sharded_refuses_what_does_not_split():
    """B2s refuses the 5-bit formats' row split and unknown modes."""
    qt = _port_qtensor(ref_core.quantize(
        jnp.asarray(np.ones((64, 8), np.float32)), "sym_int5"))
    with pytest.raises(NotImplementedError):
        b2.qmatmul_sharded(torch.ones(1, 64, dtype=torch.bfloat16), qt,
                           "row")
    with pytest.raises(NotImplementedError):
        b2.qmatmul_sharded(torch.ones(1, 64, dtype=torch.bfloat16), qt,
                           "rep")
