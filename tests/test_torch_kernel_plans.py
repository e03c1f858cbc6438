"""The launch plans of the port's two redesigned kernels, and B1's key
split emulated on the CPU.

B2 (the dequant-matmul) runs a GEMV for M <= 8 and a tiled tensor-core
product above, with a K split whose pieces hold whole quantization blocks
and whole 64-row steps.  B1 (ragged paged attention) splits the keys of
few-query rows (G*C <= 16) into whole pages, runs the split pass and
merges the partials in split order.  The kernels run only on a card
(``tests/test_torch_cuda.py``); here the plans are checked from shapes, and
the split-then-merge arithmetic is emulated in float64 (four warp slices of
each 64-key tile merged inside a split, then the splits, empty ones with
l = 0) and held against ``ragged_paged_sdpa_plain`` and the JAX kernel,
run as the JAX tests run it on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_sdpa as ref_ragged_paged_sdpa
from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from tests.test_torch_ops import B1_ULP, _f32, _ragged_case

# -- B2 ------------------------------------------------------------------------

B2_SHAPES = [(m, n, k) for m in (1, 8, 9, 16, 17, 32, 64, 100, 128, 512, 8192)
             for n, k in ((4096, 4096), (22016, 4096), (4096, 11008),
                          (12288, 4096), (32000, 4096), (200, 224))]


@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 16, 17, 32, 64, 65, 128, 8192])
def test_qmatmul_dispatch_by_m(m):
    """M <= 8 takes the GEMV instance at a row tile of 1, 2, 4 or 8 rows;
    M > 8 the tiled instance at 16, 64 or 128 rows, the smallest that
    holds M (128 above 64)."""
    route, tile, _, _ = b2.plan(m, 4096, 4096, 32)
    if m <= 8:
        assert route == "gemv" and tile in (1, 2, 4, 8) and m <= tile < 2 * m
    else:
        assert route == "tiled"
        assert tile == (16 if m <= 16 else 64 if m <= 64 else 128)


@pytest.mark.parametrize("bs", [32, 64, 128])
def test_qmatmul_tiled_split_plan(bs):
    """The tiled instance's K splits hold whole quantization blocks and
    whole 64-row steps, cover K exactly once, hold at least 512 rows, and
    appear only while the output tiles are under two waves of 132 SMs."""
    for m, n, k in B2_SHAPES:
        if m <= 8 or k % bs:
            continue
        route, tile, splits, per = b2.plan(m, n, k, bs)
        nqb = k // bs
        assert (splits - 1) * per < nqb <= splits * per
        tiles = -(-m // tile) * -(-n // 128)
        if splits > 1:
            assert tiles < 2 * 132
            assert per * bs % 64 == 0 and per * bs >= 512
        else:
            assert per == nqb


# -- B1 ------------------------------------------------------------------------

@pytest.mark.parametrize("r,hkv,gc,maxp,ps", [
    (8, 32, 1, 16, 128), (8, 32, 4, 16, 128), (8, 8, 16, 16, 128),
    (1, 8, 4, 40, 128), (6, 2, 4, 3, 32), (3, 2, 2, 4, 16),
    (8, 32, 17, 16, 128), (8, 32, 128, 16, 128)])
def test_ragged_split_plan(r, hkv, gc, maxp, ps):
    """Few-query rows split into whole pages that cover the table once,
    each split at least one 64-key tile, about 1,024 split-pass blocks at
    most; rows of more than 16 queries do not split."""
    splits, pps = b1.split_plan(r, hkv, gc, maxp, ps)
    assert (splits - 1) * pps < maxp <= splits * pps
    if gc > 16:
        assert (splits, pps) == (1, maxp)
        return
    assert splits == 1 or pps * ps >= 64
    assert splits == 1 or r * hkv * (splits - 1) < 1024


def _partial(qv, keys, k_rows, v_rows, scale):
    """(m, l, acc) of one query over ``keys`` (float64); empty: l = 0."""
    if not keys:
        return -1e30, 0.0, np.zeros(qv.shape[0])
    s = k_rows(keys) @ qv * scale
    m = s.max()
    p = np.exp(s - m)
    return m, p.sum(), p @ v_rows(keys)


def _merge(parts):
    """The kernel's merge: parts with l == 0 skipped, the rest rescaled to
    their common maximum and summed in order."""
    live = [pt for pt in parts if pt[1] > 0]
    if not live:
        return -1e30, 0.0, np.zeros_like(parts[0][2])
    m_all = max(pt[0] for pt in live)
    l, acc = 0.0, np.zeros_like(parts[0][2])
    for m, ls, a in live:
        w = np.exp(m - m_all)
        l += ls * w
        acc = acc + a * w
    return m_all, l, acc


def _emulate_split(q, k, v, tables, kv_len, chunk, *, scale, splits, pps):
    """B1's key-split instance in float64: per query, each split's keys (a
    run of pps pages, clipped to the table and the query's slot) dealt to
    four warps by 16-key slices of each 64-key tile, the warps merged, then
    the splits merged in split order."""
    r_, c_, hq, d = q.shape
    n_pages, hkv, ps, _ = k.shape
    g_ = hq // hkv
    maxp = tables.shape[1]
    qf = q.double().numpy()
    kf = k.to(torch.float32).double().numpy()
    vf = v.to(torch.float32).double().numpy()
    tab = np.clip(tables.numpy(), 0, n_pages - 1)
    out = np.zeros((r_, c_, hq, d))
    for r in range(r_):
        n_q, kvl = int(chunk[r]), int(kv_len[r])
        if n_q <= 0:
            continue
        kv_end = min(kvl, maxp * ps)
        for h in range(hkv):
            def rows(pool, keys, h=h, r=r):
                return np.stack([pool[tab[r, kp // ps], h, kp % ps]
                                 for kp in keys])

            def k_rows(keys):
                return rows(kf, keys)

            def v_rows(keys):
                return rows(vf, keys)

            for g in range(g_):
                for c in range(n_q):
                    qpos = kvl - n_q + c
                    qv = qf[r, c, h * g_ + g]
                    split_parts = []
                    for s in range(splits):
                        lo = s * pps * ps
                        hi = min((s + 1) * pps * ps, kv_end, qpos + 1)
                        warp_parts = [_partial(
                            qv, [kp for kp in range(lo, hi)
                                 if (kp - lo) % 64 // 16 == w],
                            k_rows, v_rows, scale) for w in range(4)]
                        split_parts.append(_merge(warp_parts))
                    _, l, acc = _merge(split_parts)
                    out[r, c, h * g_ + g] = acc / (l if l > 0 else 1.0)
    return torch.from_numpy(out).to(torch.bfloat16)


@pytest.mark.parametrize("pool", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("plan", ["planned", "page per split"])
def test_ragged_split_then_merge_matches_plain_and_pallas(pool, c, plan):
    """G = 4 (8 query heads over 2 kv heads), decode (C=1) and verify (C=4)
    rows with -1 table tails and two idle rows at the sentinel kv_len: the
    split-then-merge emulation, at the wrapper's plan and at one page a
    split (splits past a row's live pages empty), agrees with the plain
    version and the JAX kernel on every valid query, each query row within
    one bf16 ulp of its largest output (the existing B1 tests' bound)."""
    dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e5m2
    jax_args, torch_args, chunk = _ragged_case(dt, hq=8, hkv=2, d=16, c=c)
    q, k, v, tables, kv_len, _ = torch_args
    r_, _, hq, d = q.shape
    maxp, ps, hkv = tables.shape[1], k.shape[2], k.shape[1]
    splits, pps = (b1.split_plan(r_, hkv, hq // hkv * c, maxp, ps)
                   if plan == "planned" else (maxp, 1))
    assert hq // hkv * c <= 16                       # the split instance
    got = _f32(_emulate_split(*torch_args, scale=d ** -0.5, splits=splits,
                              pps=pps))
    plain = _f32(b1.ragged_paged_sdpa(*torch_args))
    want = _f32(ref_ragged_paged_sdpa(*jax_args))
    for i, n in enumerate(chunk):
        if n == 0:
            assert not got[i].any() and not plain[i].any()
            continue
        for ref in (plain, want):
            np.testing.assert_allclose(
                got[i, :n], ref[i, :n], rtol=0,
                atol=B1_ULP * np.abs(ref[i, :n]).max())
