"""The port's split paged attention (B5) against the JAX Pallas kernel.

``paged_decode_sdpa`` and ``paged_prefill_sdpa`` run their plain version
for CPU tensors; the JAX kernel runs in the Pallas interpreter on the CPU,
as ``tests/test_pallas.py`` runs it.  The cases are that file's two
fixtures (the decode rows of :222 and the prefill chunks of :183) and a row
mix of the port's own: unallocated (-1) table tails, a row whose history is
shorter than the chunk (its early queries see no key), an empty row, and an
e5m2 pool.  Tolerance, per query row: one bf16 ulp of the row's largest
output, 2^-7 * max|want[row]|.  Both sides round the output to bf16, and
the JAX kernel also rounds the probabilities to bf16 before the P.V
product, where the plain version works in float64.

B5 is B1's oracle in these two regimes, so B1's plain version must equal
B5's bit for bit on the same inputs.  The kernel itself runs only on a
card: ``tests/test_torch_cuda.py`` holds it there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.ops.pallas.paged_attention import \
    paged_decode_sdpa as ref_paged_decode_sdpa
from ipex_llm_tpu.ops.pallas.paged_attention import \
    paged_prefill_sdpa as ref_paged_prefill_sdpa
from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from tests.test_torch_ops import _bf16, _f32

ULP = 2.0 ** -7


def _pool(rng, shape, storage):
    """The same pool on both sides: (jnp array, torch tensor)."""
    a = rng.standard_normal(shape).astype(np.float32)
    if storage == "bf16":
        return _bf16(a)
    j = jnp.asarray(a, jnp.float8_e5m2)
    t = torch.from_numpy(np.asarray(j).view(np.uint8).copy()).view(
        torch.float8_e5m2)
    return j, t


def _case(name: str, storage: str = "bf16"):
    """(q, k_pool, v_pool, tables, kv_len) as (jax args, torch args)."""
    if name == "decode":            # tests/test_pallas.py:222
        rng = np.random.default_rng(31)
        r, hkv, hq, d, ps, n_pages, maxp, c = 3, 2, 4, 16, 32, 9, 4, 1
        tables = np.full((r, maxp), -1, np.int32)
        tables[0, :2] = [3, 5]
        tables[1, :4] = [1, 7, 2, 8]
        tables[2, :1] = [6]
        kv_len = np.asarray([40, 120, 7], np.int32)
    elif name == "prefill":         # tests/test_pallas.py:183
        rng = np.random.default_rng(33)
        r, hkv, hq, d, ps, n_pages, maxp, c = 2, 2, 4, 16, 32, 9, 4, 16
        tables = np.full((r, maxp), -1, np.int32)
        tables[0, :3] = [3, 5, 1]
        tables[1, :2] = [7, 2]
        kv_len = np.asarray([50 + c, 33 + c], np.int32)
    else:                           # the port's row mix, C = 4 or 1
        rng = np.random.default_rng(35)
        c = 4 if name == "mix C=4" else 1
        r, hkv, hq, d, ps, maxp = 6, 2, 8, 16, 16, 6
        n_pages = 1 + r * maxp
        kv_len = np.asarray([1, 2, 37, 96, 0, 50], np.int32)
        tables = rng.permutation(np.arange(1, n_pages)).astype(np.int32)
        tables = tables[: r * maxp].reshape(r, maxp).copy()
        for i in range(r):          # unallocated tails
            tables[i, -(-int(kv_len[i]) // ps):] = -1
    k_j, k_t = _pool(rng, (n_pages, hkv, ps, d), storage)
    v_j, v_t = _pool(rng, (n_pages, hkv, ps, d), storage)
    q_j, q_t = _bf16(rng.standard_normal((r, c, hq, d)))
    return ((q_j, k_j, v_j, jnp.asarray(tables), jnp.asarray(kv_len)),
            (q_t, k_t, v_t, torch.from_numpy(tables),
             torch.from_numpy(kv_len)))


CASES = [("decode", "bf16"), ("prefill", "bf16"), ("mix C=4", "bf16"),
         ("mix C=4", "e5m2"), ("mix C=1", "e5m2")]


def _port(args):
    fn = (b5.paged_decode_sdpa if args[0].shape[1] == 1
          else b5.paged_prefill_sdpa)
    return fn(*args)


@pytest.mark.parametrize("name,storage", CASES)
def test_plain_matches_pallas_kernel(name, storage):
    jax_args, torch_args = _case(name, storage)
    ref = (ref_paged_decode_sdpa if jax_args[0].shape[1] == 1
           else ref_paged_prefill_sdpa)
    want = _f32(ref(*jax_args))
    b5.COUNTS.reset()
    got_t = _port(torch_args)
    assert b5.COUNTS.plain_calls == 1 and b5.COUNTS.launches == 0
    assert got_t.dtype == torch.bfloat16
    assert got_t.shape == torch_args[0].shape
    got = _f32(got_t)
    kv_len = torch_args[4].numpy()
    c = got.shape[1]
    for i in range(got.shape[0]):
        for j in range(c):
            if kv_len[i] - c + j < 0:       # no visible key: exact zeros
                assert not got[i, j].any()
                continue
            np.testing.assert_allclose(
                got[i, j], want[i, j], rtol=0,
                atol=ULP * np.abs(want[i, j]).max(), err_msg=f"row {i} q {j}")


@pytest.mark.parametrize("name,storage", CASES)
def test_b1_plain_equals_b5_plain(name, storage):
    """B1 over uniform chunks (chunk_len = C for every row) is B5: the two
    plain versions agree bitwise on every query, zeros included."""
    _, args = _case(name, storage)
    q, k, v, tables, kv_len = args
    got = _port(args)
    chunk = torch.full((q.shape[0],), q.shape[1], dtype=torch.int32)
    want = b1.ragged_paged_sdpa(q, k, v, tables, kv_len, chunk)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_wrappers_reject_what_they_do_not_take():
    _, (q, k, v, tables, kv_len) = _case("mix C=4")
    with pytest.raises(ValueError):
        b5.paged_decode_sdpa(q, k, v, tables, kv_len)
    with pytest.raises(NotImplementedError):
        b5.paged_prefill_sdpa(q[:, :, :3], k, v, tables, kv_len)


@pytest.mark.parametrize("r,hkv,gc,maxp,want", [
    (8, 32, 1, 16, (8, 2)),         # decode at Llama-2-7B widths
    (8, 32, 4, 16, (8, 2)),         # verify chunks, spec_k = 3
    (8, 32, 128, 16, (2, 8)),       # C = 128: 64-row tiles, still split
    (1, 1, 1, 3, (3, 1)),           # never more splits than pages
])
def test_split_plan(r, hkv, gc, maxp, want):
    splits, pps = b5.split_plan(r, hkv, gc, maxp)
    assert (splits, pps) == want
    assert (splits - 1) * pps < maxp <= splits * pps
