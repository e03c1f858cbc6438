"""The launch plans of the port's redesigned kernels, and the splits of
B1, B3, B5 and B2's GEMV emulated on the CPU.

B2 (the dequant-matmul) runs a GEMV for M <= 8, whose K split over a
block's warps and a thread-block cluster meets in shared memory (one
launch), and a tiled tensor-core product above, with a K split whose
pieces hold whole quantization blocks and whole 64-row steps; the GEMV's
fragment map (which codes each lane decodes into its mma.sync registers)
is checked against planes the codec packs.  B1 (ragged paged attention)
splits the keys of few-query rows (G*C <= 16) into whole pages, runs the
split pass and merges the partials in split order.  B3 (dense decode
attention) splits each row's visible range evenly on the device and
merges the same way.  B4 (flash attention) walks only the key tiles its
queries can see and compares slots only on tiles that cross a boundary.
B5 (split paged attention) splits every row's pages at every chunk width
and walks, skips and masks key tiles per warp.  The kernels run only on a
card (``tests/test_torch_cuda.py``); here the plans are checked from
shapes, and the split-then-merge arithmetic is emulated in float64 and
held against the plain versions and the JAX kernels, run as the JAX tests
run them on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.ops.pallas.decode_attention import decode_sdpa as ref_decode
from ipex_llm_tpu.ops.pallas.paged_attention import \
    paged_decode_sdpa as ref_paged_decode
from ipex_llm_tpu.ops.pallas.paged_attention import \
    paged_prefill_sdpa as ref_paged_prefill
from ipex_llm_tpu.ops.linear import qmatmul_reference
from ipex_llm_tpu.ops.pallas.qmatmul import qmatmul_pallas
from ipex_llm_tpu.ops.pallas.ragged_paged_attention import \
    ragged_paged_sdpa as ref_ragged_paged_sdpa
from ipex_llm_tpu.quantize import core as ref_core
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.quantize import core as qcore
from ipex_llm_tpu_torch.quantize.qtypes import resolve
from tests.test_torch_attention_dense import _pair, assert_rows_close
from tests.test_torch_ops import (B1_ULP, _bf16, _f32, _port_qtensor,
                                  _ragged_case)

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
    (8, 32, 17, 16, 128), (8, 32, 128, 16, 128),
    # Qwen2-7B (G = 7) at the card's serving shape, 48 pages of 128:
    # decode and C = 2 split, the verify chunks (C = 4) and C = 128 do not
    (8, 4, 7, 48, 128), (8, 4, 14, 48, 128), (8, 4, 28, 48, 128),
    (8, 4, 896, 48, 128),
    # GLM-4-9B (G = 16 over 2 kv heads) at the card's serving shape:
    # decode splits (16 rows), C = 2 and 4 and a 128-token chunk do not
    (8, 2, 16, 16, 128), (8, 2, 32, 16, 128), (8, 2, 64, 16, 128),
    (8, 2, 2048, 16, 128)])
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


@pytest.mark.parametrize("pool", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 2])
def test_ragged_split_at_group_7_matches_plain_and_pallas(pool, c):
    """Qwen2's GQA group of 7 (7 query heads over 1 kv head): G*C = 7 and
    14 pad to the split instance's 16-row tile; the split-then-merge
    emulation at the wrapper's plan agrees with the plain version and the
    JAX kernel on every valid query (G*C > 16, C >= 3, takes the query
    tiles, which tests/test_torch_cuda.py holds on the card)."""
    dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e5m2
    jax_args, torch_args, chunk = _ragged_case(dt, hq=7, hkv=1, d=16, c=c)
    q, k, v, tables, kv_len, _ = torch_args
    r_, _, hq, d = q.shape
    maxp, ps = tables.shape[1], k.shape[2]
    assert 7 * c <= 16 < 7 * 3
    splits, pps = b1.split_plan(r_, 1, 7 * c, maxp, ps)
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


# -- B3 ------------------------------------------------------------------------

B3_SHAPES = [(4, 8, 2304), (1, 8, 4864), (1, 2, 128), (64, 32, 256),
             (4, 8, 100), (2, 1, 70000), (3, 2, 700)]


@pytest.mark.parametrize("b,hkv,s", B3_SHAPES)
def test_decode_split_bounds_cover_the_visible_range(b, hkv, s):
    """Each row's visible range [lo, kv_len) splits, on the device, into
    the plan's number of pieces that cover it exactly once; no split is
    empty while another holds more than one 64-key tile; the plan takes
    as many splits as one wave of resident blocks (2 an SM on 132 SMs)
    holds, within the caps of 64 and one split per 64-key tile."""
    splits = b3.split_plan(b, hkv, s)
    cap = min(64, -(-s // 64))
    assert 1 <= splits <= cap
    assert splits == 1 or b * hkv * splits <= 2 * 132      # one wave
    assert splits == cap or b * hkv * (splits + 1) > 2 * 132   # all of it
    gen = torch.Generator().manual_seed(s)
    for _ in range(20):
        hi = torch.randint(0, s + 1, (b,), generator=gen)
        lo = (torch.rand(b, generator=gen) * (hi + 1)).long().clamp(max=hi)
        lo[0], hi[0] = 0, s                 # a full row
        start, end = b3.split_bounds(lo, hi, splits)
        for r in range(b):
            keys = [k for a, e in zip(start[r].tolist(), end[r].tolist())
                    for k in range(a, e)]
            assert keys == list(range(int(lo[r]), int(hi[r])))
            n = (end[r] - start[r]).clamp(min=0)
            assert n.max() <= 64 or n.min() > 0


def _emulate_decode_split(q, k, v, kv_len, kv_start, won, *, scale, window,
                          softcap, splits):
    """B3's split pass and merge in float64: each split's slots (from
    ``split_bounds``) dealt to four warps by 16-key slices of each 64-key
    tile from the split's first slot, the warps merged in warp order, then
    the splits in split order (l = 0 skipped)."""
    b, _, hq, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g_ = hq // hkv
    qf, kf, vf = (x.to(torch.float64) for x in (q, k.to(torch.bfloat16),
                                                v.to(torch.bfloat16)))
    lo = b3.first_visible(kv_len, kv_start, won, window)
    start, end = b3.split_bounds(lo, kv_len.clamp(max=s), splits)
    out = torch.zeros(b, 1, hq, d, dtype=torch.float64)
    for r in range(b):
        for h in range(hkv):
            for g in range(g_):
                qv = qf[r, 0, h * g_ + g]

                def part(keys, r=r, h=h, qv=qv):
                    if not keys:
                        return -1e30, 0.0, np.zeros(d)
                    x = kf[r, h, keys] @ qv * scale
                    if softcap is not None:
                        x = torch.tanh(x / softcap) * softcap
                    m = x.max()
                    p = torch.exp(x - m)
                    return float(m), float(p.sum()), (p @ vf[r, h, keys]
                                                      ).numpy()

                split_parts = []
                for a, e in zip(start[r].tolist(), end[r].tolist()):
                    warp_parts = [part([kp for kp in range(a, e)
                                        if (kp - a) % 64 // 16 == w])
                                  for w in range(4)]
                    split_parts.append(_merge(warp_parts))
                _, l, acc = _merge(split_parts)
                out[r, 0, h * g_ + g] = torch.from_numpy(
                    acc / (l if l > 0 else 1.0))
    return out.to(torch.bfloat16)


# the shared memory an H100 gives a block, and an SM to its blocks
SMEM_BLOCK, SMEM_SM = 232448, 233472


@pytest.mark.parametrize("d", [80, 96, 128, 256])
@pytest.mark.parametrize("fp8", [False, True])
def test_decode_ring_plan_fits_the_sm(d, fp8):
    """B3's ring: three bf16 stages of a 64-key K/V tile pair (or four raw
    e5m2 stages and the widened pair), 96 KiB at head_dim 128 (two blocks
    an SM), and at 80 and 96, whose tile rows keep 128's width; at 256 the
    pair doubles and the 16 query rows join it in shared memory: 200 KiB,
    one block an SM."""
    stages, smem, resident = b3.ring_plan(d, fp8)
    assert stages == (4 if fp8 else 3)
    assert smem <= SMEM_BLOCK and resident * smem <= SMEM_SM
    assert (smem, resident) == ((96 * 1024, 2) if d <= 128
                                else (200 * 1024, 1))


@pytest.mark.parametrize("b,hkv,s", [(4, 8, 6144), (8, 8, 6144),
                                     (1, 8, 8192), (3, 2, 700)])
def test_decode_split_plan_at_head_dim_256(b, hkv, s):
    """At head_dim 256 one wave is one block an SM: the plan fills it
    (Gemma-2's 8 kv heads at B = 4 and 8 over a 6144-slot capacity) within
    the caps, from shapes alone, and its splits cover each visible range
    once."""
    splits = b3.split_plan(b, hkv, s, 256)
    cap = min(64, -(-s // 64))
    assert 1 <= splits <= cap
    assert splits == 1 or b * hkv * splits <= 132
    assert splits == cap or b * hkv * (splits + 1) > 132
    assert splits <= b3.split_plan(b, hkv, s, 128)
    lo = torch.tensor([0, 2048, 0, 5][:b] + [0] * max(0, b - 4))
    hi = torch.full((b,), s)
    start, end = b3.split_bounds(lo, hi, splits)
    for r in range(b):
        keys = [k for a, e in zip(start[r].tolist(), end[r].tolist())
                for k in range(a, e)]
        assert keys == list(range(int(lo[r]), s))


@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("case", ["window cuts", "softcap"])
def test_decode_split_then_merge_at_head_dim_256(storage, case):
    """The split-then-merge emulation at head_dim 256 and the wrapper's
    plan (G = 2, a 192-slot cache, left padding, a row that sees no key)
    agrees with ``decode_sdpa_plain`` and the JAX kernel within 2^-7 of
    each row's largest output."""
    kw = {"window cuts": dict(window=48), "softcap": dict(softcap=5.0)}[case]
    rng = np.random.default_rng(12)
    b, s, hq, hkv, d = 3, 192, 4, 2, 256
    q_t, q_j = _pair(rng, (b, 1, hq, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d), storage)
    v_t, v_j = _pair(rng, (b, hkv, s, d), storage)
    kv_len = np.array([150, 192, 70], np.int32)
    kv_start = np.array([0, 37, 70], np.int32)
    kl, ks = torch.from_numpy(kv_len), torch.from_numpy(kv_start)
    won = torch.ones(b, dtype=torch.int32)
    got = _emulate_decode_split(q_t, k_t, v_t, kl, ks, won, scale=d ** -0.5,
                                window=kw.get("window"),
                                softcap=kw.get("softcap"),
                                splits=b3.split_plan(b, hkv, s, d))
    plain = b3.decode_sdpa(q_t, k_t, v_t, kv_len=kl, kv_start=ks, **kw)
    want = ref_decode(q_j, k_j, v_j, kv_len=jnp.asarray(kv_len),
                      kv_start=jnp.asarray(kv_start), **kw)
    assert not got[2].float().any()
    for ref in (plain, want):
        assert_rows_close(got, ref, what=f"{storage} {case} D=256")


B3_EMULATED = {"plain": {}, "window cuts": dict(window=48),
               "softcap": dict(softcap=30.0)}


@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("case", sorted(B3_EMULATED))
@pytest.mark.parametrize("plan", ["planned", "many splits"])
def test_decode_split_then_merge_matches_plain_and_pallas(storage, case,
                                                          plan):
    """G = 4 over a 256-slot cache, rows with left padding and ragged fill
    and one row that sees no key: the split-then-merge emulation, at the
    wrapper's plan and at 40 splits (short splits, the last ones empty),
    agrees with ``decode_sdpa_plain`` and the JAX kernel within 2^-7 of
    each row's largest output, and gives exact zeros on the empty row."""
    kw = B3_EMULATED[case]
    rng = np.random.default_rng(11)
    b, s, hq, hkv, d = 3, 256, 8, 2, 128
    q_t, q_j = _pair(rng, (b, 1, hq, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d), storage)
    v_t, v_j = _pair(rng, (b, hkv, s, d), storage)
    kv_len = np.array([200, 256, 90], np.int32)
    kv_start = np.array([0, 37, 90], np.int32)
    kl, ks = torch.from_numpy(kv_len), torch.from_numpy(kv_start)
    won = torch.ones(b, dtype=torch.int32)
    splits = b3.split_plan(b, hkv, s) if plan == "planned" else 40
    got = _emulate_decode_split(q_t, k_t, v_t, kl, ks, won,
                                scale=d ** -0.5, window=kw.get("window"),
                                softcap=kw.get("softcap"), splits=splits)
    plain = b3.decode_sdpa(q_t, k_t, v_t, kv_len=kl, kv_start=ks, **kw)
    want = ref_decode(q_j, k_j, v_j, kv_len=jnp.asarray(kv_len),
                      kv_start=jnp.asarray(kv_start), **kw)
    assert not got[2].float().any()
    for ref in (plain, want):
        assert_rows_close(got, ref, what=f"{storage} {case} {plan}")


@pytest.mark.parametrize("g", [1, 7, 16, 17, 32, 71, 128])
def test_decode_row_tiles_cover_the_group(g):
    """A GQA group runs as 16-row tiles, as each block finds its rows on
    the device: every query row of the group once, in order, the tiles
    full but the last (Falcon-7B's 71: four of 16 and one of 7)."""
    tiles = b3.row_tiles(g)
    assert len(tiles) == -(-g // 16)
    rows = [g0 + i for g0, n in tiles for i in range(n)]
    assert rows == list(range(g))
    assert all(n == 16 for _, n in tiles[:-1]) and 1 <= tiles[-1][1] <= 16


@pytest.mark.parametrize("b,hkv,s,d,g,want", [
    (8, 1, 2048, 64, 71, 6), (4, 1, 2048, 64, 71, 13),
    (8, 2, 2048, 128, 16, 16), (8, 2, 2048, 128, 17, 8),
    (8, 2, 2048, 128, 32, 8), (1, 1, 4096, 64, 71, 52),
    (64, 1, 2048, 64, 71, 1)])
def test_decode_split_plan_counts_the_row_tiles(b, hkv, s, d, g, want):
    """Above a group of 16 each of its row tiles is a block beside each
    split, and the plan fills one wave of them (2 blocks an SM at 64 and
    128 on 132 SMs) within the caps, from shapes alone; at 16 and below
    the plan is the one-tile plan as it was (GLM-4-9B's G = 16)."""
    splits = b3.split_plan(b, hkv, s, d, None, g)
    assert splits == want
    blocks = b * hkv * len(b3.row_tiles(g))
    cap = min(64, -(-s // 64))
    assert splits == 1 or blocks * splits <= 2 * 132
    assert splits == cap or blocks * (splits + 1) > 2 * 132
    if g <= 16:
        assert splits == b3.split_plan(b, hkv, s, d)


@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g,d,case", [(17, 128, "window cuts"),
                                      (32, 128, "softcap"),
                                      (71, 64, "plain"),
                                      (71, 64, "window cuts")])
def test_decode_split_then_merge_at_large_groups(storage, g, d, case):
    """The split-then-merge emulation at the wrapper's plan for groups
    above 16 (G = 17 and 32 at head_dim 128, Falcon-7B's 71 over one kv
    head at 64; left padding, a row that sees no key) agrees with
    ``decode_sdpa_plain`` and the JAX kernel within 2^-7 of each row's
    largest output."""
    kw = B3_EMULATED[case]
    rng = np.random.default_rng(g + d)
    b, s, hkv = 3, 256, 1 if g == 71 else 2
    hq = g * hkv
    q_t, q_j = _pair(rng, (b, 1, hq, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d), storage)
    v_t, v_j = _pair(rng, (b, hkv, s, d), storage)
    kv_len = np.array([200, 256, 90], np.int32)
    kv_start = np.array([0, 37, 90], np.int32)
    kl, ks = torch.from_numpy(kv_len), torch.from_numpy(kv_start)
    won = torch.ones(b, dtype=torch.int32)
    got = _emulate_decode_split(
        q_t, k_t, v_t, kl, ks, won, scale=d ** -0.5, window=kw.get("window"),
        softcap=kw.get("softcap"),
        splits=b3.split_plan(b, hkv, s, d, None, g))
    plain = b3.decode_sdpa(q_t, k_t, v_t, kv_len=kl, kv_start=ks, **kw)
    want = ref_decode(q_j, k_j, v_j, kv_len=jnp.asarray(kv_len),
                      kv_start=jnp.asarray(kv_start), **kw)
    assert not got[2].float().any()
    for ref in (plain, want):
        assert_rows_close(got, ref, what=f"{storage} {case} G={g}")


# -- B4 ------------------------------------------------------------------------

@pytest.mark.parametrize("d", [80, 96, 128, 256])
def test_flash_smem_plan_fits_the_sm(d):
    """B4's ring of 64-key K/V tile pairs: three stages at head_dim 128
    (97 KiB with the swizzle's alignment slack, two blocks an SM), and at
    80 and 96, whose tiles are laid out 128 columns wide; at 256 two
    stages of 64 KiB pairs and the block's 64 query rows (32 KiB, read
    through a descriptor): 161 KiB, one block an SM."""
    stages, smem, resident = b4.smem_plan(d)
    assert smem <= SMEM_BLOCK and resident * smem <= SMEM_SM
    assert (stages, smem, resident) == ((3, 97 * 1024, 2) if d <= 128
                                        else (2, 161 * 1024, 1))


@pytest.mark.parametrize("d", [80, 128, 256])
@pytest.mark.parametrize("split", [False, True])
def test_ragged_smem_plan_fits_the_sm(d, split):
    """B1's four 64-key K/V tiles: 64 KiB at head_dim 128 with Q in
    registers, and at 80, whose tile rows keep 128's width; at 256 128 KiB
    and the block's query rows in shared memory (64 rows of the query
    tiles, 32 KiB; 16 of the key split, 8 KiB), one block an SM."""
    smem, q_smem = b1.smem_plan(d, split)
    assert smem <= SMEM_BLOCK and q_smem == (d == 256)
    if d <= 128:
        assert smem == 64 * 1024 + 16 and 3 * smem <= SMEM_SM
    else:
        assert smem == 128 * 1024 + 128 + (8 if split else 32) * 1024
        assert 2 * smem > SMEM_SM

FLASH_WALKS = {
    "left padded, T=200": dict(t=200, kv_start=[0, 77, 199]),
    "window cuts, T=1000": dict(t=1000, kv_start=[0, 300, 990], window=150),
    "window per row": dict(t=300, kv_start=[0, 5, 64], window=100,
                           won=[1, 0, 1]),
    "chunk after a prefix": dict(t=100, offset=437, kv_start=[0, 8, 100],
                                 window=64),
    "non-causal, kv_len < S": dict(t=130, causal=False, kv_start=[0, 11, 3],
                                   kv_len=[194, 150, 77]),
}


@pytest.mark.parametrize("case", sorted(FLASH_WALKS))
def test_flash_tile_walk_covers_visible_pairs(case):
    """Per block of 64 queries, the key tiles it walks hold every (query,
    key) pair its live queries see; per warp of 16 queries, a tile the
    warp skips holds no visible pair of its rows and a tile it runs
    without the mask holds no masked one."""
    c = FLASH_WALKS[case]
    t, causal, off = c["t"], c.get("causal", True), c.get("offset", 0)
    s = t + off + 64
    window = c.get("window")
    for r, kvs in enumerate(c["kv_start"]):
        kvl = min(c.get("kv_len", [t + off] * 3)[r], s)
        win = window if causal and window and c.get("won", [1] * 3)[r] \
            else None
        qpos = np.arange(t) + off
        kpos = np.arange(s)
        vis = np.broadcast_to((kpos >= kvs) & (kpos < kvl), (t, s)).copy()
        if causal:
            vis &= kpos[None] <= qpos[:, None]
            if win is not None:
                vis &= kpos[None] > qpos[:, None] - win
        for q0 in range(0, t, b4.Q_TILE):
            blk = qpos[q0:q0 + b4.Q_TILE]
            tiles = b4.key_tiles(int(blk.min()), int(blk.max()), kvs, kvl,
                                 causal=causal, window=win)
            walked = np.zeros(s, bool)
            for kt in tiles:
                walked[kt:kt + b4.K_TILE] = True
            assert not (vis[q0:q0 + b4.Q_TILE] & ~walked[None]).any()
            for w0 in range(q0, min(q0 + b4.Q_TILE, t), b4.WARP_ROWS):
                rows = vis[w0:w0 + b4.WARP_ROWS]
                wq = qpos[w0:w0 + b4.WARP_ROWS]
                for kt in tiles:
                    kind = b4.tile_kind(kt, int(wq.min()), int(wq.max()),
                                        kvs, kvl, causal=causal, window=win)
                    tile = rows[:, kt:kt + b4.K_TILE]
                    if kind == b4.SKIP:
                        assert not tile.any(), (case, r, w0, kt)
                    elif kind == b4.FREE:
                        assert tile.all() and tile.shape[1] == b4.K_TILE, \
                            (case, r, w0, kt)
    # the mask-free rule is not vacuous on these cases
    assert b4.tile_kind(0, 64, 79, 0, 2048, causal=True, window=None) == \
        b4.FREE


# -- B2's GEMV instance (M <= 8) -------------------------------------------

LLAMA2_7B = ((4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096),
             (4096, 32000))
MISTRAL_7B = ((4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096),
              (4096, 32000))


@pytest.mark.parametrize("model", ["llama2-7b", "mistral-7b"])
@pytest.mark.parametrize("qtype", b2.FORMATS)
def test_qmatmul_gemv_plan_covers_every_block_once(model, qtype):
    """At M = 1 .. 8 and each of the model's five weight shapes, the GEMV
    plan takes the call in one launch, with at most 8 cluster ranks and
    4 warps along K; its splits (rank * warps_k + warp) cover every
    quantization block exactly once, its column blocks every column, and
    a block's bf16 x stage fits in 64 KiB."""
    bs = resolve(qtype).block_size
    for m in range(1, 9):
        for k, n in (LLAMA2_7B if model == "llama2-7b" else MISTRAL_7B):
            route, tile, splits, per = b2.plan(m, n, k, bs)
            gp = b2.gemv_plan(m, n, k, bs)
            assert route == "gemv" and tile == b2.tile_rows(m)
            assert b2.launches(route, splits) == 1 and 1 <= gp.cluster <= 8
            assert gp.warps_k in (1, 2, 4) and per == gp.qb_per_warp
            nqb = k // bs
            seen = np.zeros(nqb, int)
            for rank in range(gp.cluster):
                for wk in range(gp.warps_k):
                    s = rank * gp.warps_k + wk
                    seen[s * per:min(nqb, (s + 1) * per)] += 1
            assert (seen == 1).all()
            assert (splits - 1) * per < nqb <= splits * per <= \
                gp.splits * per
            assert gp.col_blocks * (4 // gp.warps_k) * 128 >= n
            assert tile * gp.x_rows(bs) * 2 <= 64 * 1024


@pytest.mark.parametrize("layout,bs,qtype", [
    ("nib4", 32, "sym_int4"), ("nib4", 64, "nf4"), ("bit5", 32, "sym_int5"),
    ("byte", 32, "sym_int8"), ("byte", 64, "fp6"), ("byte", 128, "fp8_e5m2")])
def test_qmatmul_gemv_fragment_map(layout, bs, qtype):
    """The GEMV lanes' A fragments, as ``gemv_fragment_map`` mirrors the
    kernel: in every k-step each 16 x 16 A tile is filled exactly once,
    from 16 distinct columns (two per lane group) and the step's 16
    contraction rows, every row of the block once over its steps; the A k
    index maps to the same contraction row in every A row and in x's B
    fragment; and each code read where the map says (data row, nibble,
    fifth bit) of planes packed by the codec is the code of that (row,
    column)."""
    fm = b2.gemv_fragment_map(layout, bs)
    steps = bs // 16
    bits = {"nib4": 4, "bit5": 5, "byte": 8}[layout]
    rng = np.random.default_rng(bs + bits)
    codes = rng.integers(0, 2 ** min(bits, 8), (bs, 128))
    packed = qcore._pack_codes(torch.from_numpy(codes).to(torch.uint8), bs,
                               bits).numpy()
    data = packed[:bs // 2] if bits in (4, 5) else packed
    hb = packed[bs // 2:] if bits == 5 else None
    covered = np.zeros((bs, 128), int)
    for st in range(steps):
        for tile in range(8):
            sl = (st, slice(None), tile)
            ar, ak = fm["a_row"][sl].ravel(), fm["a_k"][sl].ravel()
            n, k = fm["n"][sl].ravel(), fm["k"][sl].ravel()
            assert len(set(zip(ar, ak))) == 256 and ar.max() < 16
            assert len(set(zip(n, k))) == 256
            assert set(n) == {16 * g + 2 * tile + j for g in range(8)
                              for j in range(2)}
            assert set(k) == set(range(16 * st, 16 * st + 16)) or \
                layout != "byte"
            # one contraction row per A k, shared by x's B fragment
            k_of = {}
            for a, kk in zip(ak, k):
                assert k_of.setdefault(a, kk) == kk
            for ln in range(32):
                for reg in range(2):
                    for h in range(2):
                        a = 2 * (ln % 4) + h + 8 * reg
                        assert fm["x_k"][st, ln, reg, h] == k_of[a]
            np.add.at(covered, (k, n), 1)
            dr, sh = fm["data_row"][sl].ravel(), fm["shift"][sl].ravel()
            got = (data[dr, n] >> sh) & (0xF if bits in (4, 5) else 0xFF)
            if bits == 5:
                br, bt = fm["bit_row"][sl].ravel(), fm["bit"][sl].ravel()
                got = got | (((hb[br, n] >> bt) & 1) << 4)
            np.testing.assert_array_equal(got, codes[k, n])
    assert (covered == 1).all()


@pytest.mark.parametrize("qtype", b2.FORMATS)
def test_qmatmul_gemv_split_order_matches_plain_and_pallas(qtype):
    """The GEMV's summation in float64: each split's partial over its
    quantization blocks (dequantized bf16 weights), rounded to fp32 as the
    warps' accumulators hold it, summed in split order (rank, then the
    block's warps) in fp32 and rounded to bf16 -- at the wrapper's plan and
    at one block a split (splits past the last block empty) -- agrees with
    the plain version and the JAX Pallas kernel (interpreted) within one
    bf16 ulp of each row's largest output."""
    bs = resolve(qtype).block_size
    k, n = 4 * bs * 2, 200
    rng = np.random.default_rng(17)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    ref_qt = ref_core.quantize(jnp.asarray(w), qtype)
    qt = _port_qtensor(ref_qt)
    wq = qcore.dequantize_padded(qt).to(torch.bfloat16).double().numpy()
    nqb = k // bs
    for m in (1, 5, 8):
        xj, xt = _bf16(rng.standard_normal((m, k)))
        xd = xt.double().numpy()
        want_pallas = _f32(qmatmul_pallas(xj, ref_qt))
        plain = _f32(b2.qmatmul(xt, qt))
        gp = b2.gemv_plan(m, n, k, bs)
        for splits, per in ((gp.splits, gp.qb_per_warp), (nqb + 3, 1)):
            acc = np.zeros((m, n), np.float32)
            for s in range(splits):
                rows = slice(s * per * bs, min(k, (s + 1) * per * bs))
                acc = acc + (xd[:, rows] @ wq[rows]).astype(np.float32)
            got = _f32(torch.from_numpy(acc).to(torch.bfloat16))
            for ref in (plain, want_pallas):
                tol = 2.0 ** -7 * np.abs(ref).max(axis=1, keepdims=True)
                assert (np.abs(got - ref) <= tol).all(), (qtype, m, splits)


# -- B2e -----------------------------------------------------------------------

# per model: (experts a token takes, experts, (K, N) of gate_up and down)
B2E_MODELS = {"mixtral-8x7b": (2, 8, ((4096, 28672), (14336, 4096))),
              "qwen3-30b-a3b": (8, 128, ((2048, 1536), (768, 2048)))}


@pytest.mark.parametrize("model", sorted(B2E_MODELS))
def test_b2e_plan_by_forward(model):
    """B2e's instance from static shapes and the forward's token count:
    gemv at every decode forward (1 to 8 tokens), the tiled instance at
    the verify width (8 rows x 4 tokens), at one row's prefill chunk and
    at decode without a bound, wgmma at a prefill chunk of 8 x 128 tokens
    (one persistent block an SM); the gemv plan puts at least 720 warps
    on the card (or splits K as far as whole 128-row splits go), within 8
    cluster ranks and a 64 KiB x stage."""
    top, e, shapes = B2E_MODELS[model]
    for k, n in shapes:
        for tokens, want in ((1, "gemv"), (4, "gemv"), (8, "gemv"),
                             (32, "tiled"), (128, "tiled"),
                             (1024, "wgmma")):
            p = tokens * top
            pl = b2e.plan(p, e, n, k, 32, tokens)
            assert pl.instance == want, (k, n, tokens)
            if want == "gemv":
                gp = pl.gemv
                assert gp.warps_k in (1, 2, 4) and 1 <= gp.cluster <= 8
                warps = min(e, p) * -(-n // 128) * gp.splits
                # or no further power of two keeps 128 rows a split
                assert warps >= 720 or 2 * gp.splits > min(32, k // 128)
                assert 8 * gp.x_rows(32) * 2 <= 64 * 1024
                assert gp.col_blocks * (4 // gp.warps_k) * 128 >= n
            elif want == "wgmma":
                assert pl.blocks == 132
            else:
                assert pl.tile == b2e.tile_rows(p, e)
                assert pl.slots == b2e.slots(p, e, pl.tile)
        assert b2e.plan(8 * top, e, n, k, 32).instance == "tiled"


def _gemv_cover(counts, gp, n, nqb):
    """What the gemv instance's blocks cover, as the kernel walks it: block
    (rank, column block, slot z) takes the z-th expert that holds rows
    (or exits), 8 of its rows at a time; its warp (wn, wk) takes 128
    columns and split rank * warps_k + wk's quantization blocks.  Counts
    over (row, 128-column warp tile, quantization block)."""
    seg = np.concatenate([[0], np.cumsum(counts)])
    live = [ex for ex, c in enumerate(counts) if c]
    p = int(seg[-1])
    warps_n = 4 // gp.warps_k
    cover = np.zeros((p, -(-n // 128), nqb), int)
    for z in range(min(len(counts), p)):
        if z >= len(live):
            continue                            # past the last: exits
        ex = live[z]
        for m0 in range(seg[ex], seg[ex + 1], 8):
            rows = slice(m0, min(m0 + 8, seg[ex + 1]))
            for cb in range(gp.col_blocks):
                for rank in range(gp.cluster):
                    for warp in range(4):
                        col = cb * warps_n + warp % warps_n
                        s = rank * gp.warps_k + warp // warps_n
                        if col * 128 < n:
                            cover[rows, col, s * gp.qb_per_warp:
                                  (s + 1) * gp.qb_per_warp] += 1
    return cover


def _routed(tokens, e, top, seed):
    """Rows per expert of ``tokens`` routed to their top experts of random
    logits."""
    logits = np.random.default_rng(seed).standard_normal((tokens, e))
    idx = np.argsort(-logits, axis=1)[:, :top]
    return tuple(np.bincount(idx.ravel(), minlength=e).tolist())


@pytest.mark.parametrize("counts,k,n", [
    ((0, 1, 7, 8, 9, 0), 2048, 1536), ((0, 0, 24, 0, 0, 0), 14336, 4096),
    ((1, 1, 1, 1, 1, 1), 768, 2048), ((5,) + (0,) * 127, 2048, 1536),
    (_routed(8, 8, 2, 1), 14336, 4096), (_routed(8, 8, 2, 2), 4096, 28672),
    (_routed(8, 128, 8, 3), 768, 2048)])
def test_b2e_gemv_grid_covers_every_block_once(counts, k, n):
    """At the decode shapes, under adversarial splits (empty experts, a
    9-row segment and one expert of 24 rows past the bound of 8, 1-row
    segments, one expert of 128 holding every row) and routed ones: the
    gemv grid's ``min(E, P)`` expert slots reach every expert that holds
    rows, and its blocks cover every (row, 128-column tile, quantization
    block) of each exactly once."""
    p, e = sum(counts), len(counts)
    gp = b2e.gemv_plan(p, e, n, k, 32)
    assert gp is not None
    cover = _gemv_cover(counts, gp, n, k // 32)
    assert (cover == 1).all()


@pytest.mark.parametrize("qtype", ["sym_int4", "asym_int5", "fp8_e4m3"])
def test_b2e_gemv_split_order_matches_plain_and_reference(qtype):
    """The gemv instance's summation in float64: each split's partial over
    its quantization blocks (dequantized bf16 weights) rounded to fp32 as
    a warp's accumulators hold it, summed in split order in fp32, then
    rounded to bf16 or kept in fp32 -- at the wrapper's plan and at one
    block a split -- agrees with B2e's plain version and with the JAX
    reference's product of each expert's rows (``qmatmul_reference``)
    within one bf16 ulp of each row's largest output, over experts of 0,
    9 (past the bound: two chunks), 1 and 6 rows."""
    bs = resolve(qtype).block_size
    k, n, counts = 4 * bs * 2, 200, (0, 9, 1, 6)
    rng = np.random.default_rng(23)
    refs = [ref_core.quantize(jnp.asarray(
        (rng.standard_normal((k, n)) * 0.05).astype(np.float32)), qtype)
        for _ in counts]
    ports = [_port_qtensor(r) for r in refs]

    def stack(key):
        planes = [getattr(q, key) for q in ports]
        return None if planes[0] is None else torch.stack(planes)
    qt = qcore.QTensor(stack("data"), stack("scales"), stack("zeros"),
                       qtype, (k, n), bs)
    seg_np = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    seg = torch.from_numpy(seg_np)
    p, nqb = int(seg_np[-1]), k // bs
    xj, xt = _bf16(rng.standard_normal((p, k)))
    xd = xt.double().numpy()
    gp = b2e.gemv_plan(p, len(counts), n, k, bs)
    for keep_f32 in (False, True):
        plain = _f32(b2e.qmatmul_experts(xt, seg, qt, keep_f32=keep_f32))
        for splits, per in ((gp.splits, gp.qb_per_warp), (nqb + 3, 1)):
            got = np.zeros((p, n), np.float32)
            for ex, (lo, hi) in enumerate(zip(seg_np[:-1], seg_np[1:])):
                if hi == lo:
                    continue
                wq = qcore.dequantize_padded(ports[ex]).to(
                    torch.bfloat16).double().numpy()
                acc = np.zeros((hi - lo, n), np.float32)
                for s in range(splits):
                    rows = slice(s * per * bs, min(k, (s + 1) * per * bs))
                    acc = acc + (xd[lo:hi, rows] @ wq[rows]).astype(
                        np.float32)
                got[lo:hi] = acc if keep_f32 else _f32(
                    torch.from_numpy(acc).to(torch.bfloat16))
                want = _f32(qmatmul_reference(xj[lo:hi], refs[ex]))
                tol = 2.0 ** -7 * np.abs(want).max(axis=1, keepdims=True)
                assert (np.abs(got[lo:hi] - want) <= tol).all(), (
                    qtype, ex, splits)
            tol = 2.0 ** -7 * np.abs(plain).max(axis=1, keepdims=True)
            assert (np.abs(got - plain) <= tol).all(), (qtype, splits)


@pytest.mark.parametrize("qtype", b2.FORMATS)
def test_b2e_wgmma_smem_plan_fits_the_sm(qtype):
    """The wgmma block's shared memory in every format (two bf16 weight
    tiles of 64 x 256, the two consumers' four-stage x rings, the
    producer's four stages of packed planes, 1 KiB of alignment) fits in
    the 227 KB a block can use on the H100, one block an SM."""
    q = resolve(qtype)
    nbytes = b2e.wgmma_smem_bytes(qtype)
    stage = (64 * 256 // (2 if q.bits in (4, 5) else 1)
             + (8 * 256 if q.bits == 5 else 0)
             + max(1, 64 // q.block_size) * 512
             * (2 if q.kind == "int_asym" else 1))
    assert nbytes == 2 * 32768 + 2 * 4 * 8192 + 4 * stage + 1024
    assert nbytes <= 232448        # a block's shared memory on the H100


def _wgmma_items(counts, n, blocks):
    """The wgmma blocks' walk, as the kernel takes it: for each block, its
    items in order, each (expert, first row, segment end, first column):
    item t of block b is b + i * blocks, its row tile t % tiles (128-row
    tiles in expert order), its column tile t // tiles."""
    seg = np.concatenate([[0], np.cumsum(counts)])
    tiles = [(ex, lo, int(seg[ex + 1])) for ex in range(len(counts))
             for lo in range(seg[ex], seg[ex + 1], 128)]
    items = len(tiles) * -(-n // 256)
    return [[(*tiles[t % len(tiles)], (t // len(tiles)) * 256)
             for t in range(b, items, blocks)] for b in range(blocks)]


@pytest.mark.parametrize("counts", [
    (0, 1, 130, 9, 300, 200), (0, 0, 640, 0, 0, 0),
    _routed(1024, 8, 2, 4), _routed(1024, 128, 8, 5)])
@pytest.mark.parametrize("n,blocks", [(4096, 132), (1536, 132), (384, 7)])
def test_b2e_wgmma_tile_walk_covers_each_row_once(counts, n, blocks):
    """The wgmma instance's persistent walk covers every (row, column) of
    the output exactly once, each tile's rows inside one expert's segment
    (a tile starts a multiple of 128 rows into it), with the blocks'
    item counts at most one apart."""
    seg = np.concatenate([[0], np.cumsum(counts)])
    walk = _wgmma_items(counts, n, blocks)
    cover = np.zeros((int(seg[-1]), -(-n // 256)), int)
    for items in walk:
        for ex, lo, hi, n0 in items:
            assert seg[ex] <= lo < hi == seg[ex + 1]
            assert (lo - seg[ex]) % 128 == 0 and n0 % 256 == 0 and n0 < n
            cover[lo:min(lo + 128, hi), n0 // 256] += 1
    assert (cover == 1).all()
    sizes = [len(items) for items in walk]
    assert max(sizes) - min(sizes) <= 1


# -- B5 ------------------------------------------------------------------------

def _b5_rows(c, g, rng):
    """Rows at ragged lengths over 16-slot pages (64-slot pages for C >
    4, so that a split holds whole 64-key tiles), -1 past each row's last
    page: one empty, some shorter than C, one at the table's end."""
    r, hkv, d = 4, 2, 16
    ps, maxp = (64, 5) if c > 4 else (16, 13)
    kv_len = np.array([0, max(1, c // 2), 61 + c, maxp * ps], np.int32)
    tables = rng.permutation(np.arange(1, 1 + r * maxp)).astype(np.int32)
    tables = tables.reshape(r, maxp)
    for i in range(r):
        tables[i, -(-int(kv_len[i]) // ps):] = -1
    return r, hkv, hkv * g, d, ps, maxp, kv_len, tables


def _b5_walk(c, g, kv_len, hkv, ps, maxp, splits, pps):
    """Per (row, flat query row j): the keys the kernel's blocks would give
    it, by split: a block (query tile, split) walks key_tiles() cut at its
    rows' last slot; its warp of 16 rows runs each tile unless SKIP, and on
    a FREE tile sees every key, on a MASKED one only its visible keys."""
    gc = g * c
    rows_blk, kt = b5.query_rows(gc), b5.key_tile(gc)
    out = {}
    for r, kvl in enumerate(kv_len):
        kvl = int(kvl)
        live = min(kvl, maxp * ps)
        qpos = [kvl - c + j % c for j in range(gc)]
        for j0 in range(0, gc, rows_blk):
            blk = range(j0, min(gc, j0 + rows_blk))
            q_hi = max(qpos[j] for j in blk)
            for s in range(splits):
                k_lo = s * pps * ps
                k_hi = min(live, (s + 1) * pps * ps, q_hi + 1)
                for w0 in range(j0, j0 + rows_blk, b5.WARP_ROWS):
                    wrows = [j for j in range(w0, w0 + b5.WARP_ROWS)
                             if j < gc]
                    if not wrows:
                        continue
                    lo = min(qpos[j] for j in wrows)
                    hi = max(qpos[j] for j in wrows)
                    for k0 in b5.key_tiles(k_lo, k_hi, kt):
                        kind = b5.tile_kind(k0, lo, hi, k_hi, kt)
                        for j in wrows:
                            keys = [kp for kp in range(k0, k0 + kt)
                                    if kp < k_hi and kp <= qpos[j]]
                            if kind == b5.SKIP:
                                assert not keys
                                continue
                            if kind == b5.FREE:
                                assert len(keys) == kt
                            out.setdefault((r, j), {}).setdefault(
                                s, []).extend(keys)
    return out


@pytest.mark.parametrize("c", [1, 4, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_paged_split_walk_covers_visible_pairs_once(c, g):
    """B5's page split at every C (G*C <= 16: 16-row single-warp blocks
    over 16-key tiles; else 64-row blocks over 64-key tiles): the planned
    splits cover each row's pages once; every (query, visible key) pair
    is walked exactly once over the splits, by a tile its warp runs; a
    skipped tile holds no visible pair and a tile run without the mask
    only visible ones; a query with no visible key gets no key."""
    rng = np.random.default_rng(10 * c + g)
    r, hkv, hq, d, ps, maxp, kv_len, tables = _b5_rows(c, g, rng)
    splits, pps = b5.split_plan(r, hkv, g * c, maxp)
    assert (splits - 1) * pps < maxp <= splits * pps
    walked = _b5_walk(c, g, kv_len, hkv, ps, maxp, splits, pps)
    for rr, kvl in enumerate(kv_len):
        for j in range(g * c):
            qpos = int(kvl) - c + j % c
            want = list(range(0, min(qpos + 1, int(kvl), maxp * ps)))
            got = sorted(kp for keys in walked.get((rr, j), {}).values()
                         for kp in keys)
            assert got == want, (rr, j)
    kinds = {b5.tile_kind(k0, lo, hi, k_hi, b5.key_tile(g * c))
             for k0, lo, hi, k_hi in ((0, 200, 260, 320), (64, 0, 70, 128),
                                      (256, 100, 200, 320))}
    assert kinds == {b5.FREE, b5.MASKED, b5.SKIP}
    # the plan covers the card at Llama-2-7B widths: 1,024 or more blocks
    for cc in (1, 4, 128):
        sp, _ = b5.split_plan(8, 32, cc, 16)
        rows_blk = b5.query_rows(cc)
        assert sp > 1 and 8 * 32 * -(-cc // rows_blk) * sp >= 1024


@pytest.mark.parametrize("pool", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 4, 128])
def test_paged_split_then_merge_matches_plain_and_pallas(pool, c):
    """G = 4: each split's (m, l, acc) over the keys the walk gives it, in
    float64 over the widened pool, merged in split order with splits of l
    == 0 skipped (the merge pass), agrees with ``paged_sdpa_plain`` and the
    JAX kernel (interpreted) within 2^-7 of each query row's largest
    output; queries with no visible key are exact zeros."""
    g = 4
    rng = np.random.default_rng(c)
    r, hkv, hq, d, ps, maxp, kv_len, tables = _b5_rows(c, g, rng)
    n_pages = 1 + r * maxp
    dt = jnp.bfloat16 if pool == "bf16" else jnp.float8_e5m2
    from tests.test_torch_paged_attention import _pool
    k_j, k_t = _pool(rng, (n_pages, hkv, ps, d), pool)
    v_j, v_t = _pool(rng, (n_pages, hkv, ps, d), pool)
    q_j, q_t = _bf16(rng.standard_normal((r, c, hq, d)))
    assert k_j.dtype == dt
    splits, pps = b5.split_plan(r, hkv, g * c, maxp)
    walked = _b5_walk(c, g, kv_len, hkv, ps, maxp, splits, pps)
    kf = k_t.to(torch.float32).double().numpy()
    vf = v_t.to(torch.float32).double().numpy()
    qf = q_t.double().numpy()
    tab = np.clip(tables, 0, n_pages - 1)
    scale = d ** -0.5
    got = np.zeros((r, c, hq, d))
    for rr in range(r):
        for h in range(hkv):
            def rows(pool_, keys, rr=rr, h=h):
                return np.stack([pool_[tab[rr, kp // ps], h, kp % ps]
                                 for kp in keys])
            for j in range(g * c):
                gg, cc = j // c, j % c
                qv = qf[rr, cc, h * g + gg]
                by_split = walked.get((rr, j), {})
                parts = [_partial(qv, by_split.get(s, []),
                                  lambda ks: rows(kf, ks),
                                  lambda ks: rows(vf, ks), scale)
                         for s in range(splits)]
                _, l, acc = _merge(parts)
                got[rr, cc, h * g + gg] = acc / (l if l > 0 else 1.0)
    got = _f32(torch.from_numpy(got).to(torch.bfloat16))
    args_t = (q_t, k_t, v_t, torch.from_numpy(tables),
              torch.from_numpy(kv_len))
    args_j = (q_j, k_j, v_j, jnp.asarray(tables), jnp.asarray(kv_len))
    fn = b5.paged_decode_sdpa if c == 1 else b5.paged_prefill_sdpa
    ref_fn = ref_paged_decode if c == 1 else ref_paged_prefill
    for ref in (_f32(fn(*args_t)), _f32(ref_fn(*args_j))):
        top = np.abs(ref).max(axis=(2, 3), keepdims=True)
        assert (np.abs(got - ref) <= 2.0 ** -7 * top).all(), (pool, c)
    empty = (kv_len[:, None] - c + np.arange(c)) < 0
    assert not got[empty].any()


# -- B4's backward (training) --------------------------------------------------

from ipex_llm_tpu_torch.ops.cuda import flash_attention_bwd as b4b  # noqa: E402
from ipex_llm_tpu_torch.ops.cuda import qmatmul_dx as b2t  # noqa: E402


@pytest.mark.parametrize("b,t,hq,hkv", [(2, 1024, 32, 32), (2, 2048, 32, 8),
                                        (1, 63, 4, 1)])
def test_flash_bwd_plan(b, t, hq, hkv):
    """Two launches: dq over (q head, row, 64-query tile), dkdv over (kv
    head, row, 64-key tile); four padded 64 x 128 bf16 tiles of shared
    memory (68 KiB, three blocks an SM)."""
    p = b4b.plan(b, t, hq, hkv, t)
    assert p.dq_grid == (hq, b, -(-t // 64))
    assert p.dkdv_grid == (hkv, b, -(-t // 64))
    assert p.smem == 69632 and 3 * p.smem <= SMEM_SM
    assert b4b.LAUNCHES == 2


def _emulate_flash_bwd(q, k, v, dout, *, scale, causal, qpos, kv_len,
                       kv_start):
    """The two kernels' arithmetic in float64 over their tile walks: the
    forward's P rebuilt from its lse, Delta = rowsum(dO o), dQ by query
    tiles over the key tiles they walk, dK and dV by key tiles over the
    query tiles they visit and the G heads of their kv head, in order."""
    b, t, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    q, k, v, dout = (x.double() for x in (q, k, v, dout))
    lse = b4.lse_plain(q, k, scale=scale, causal=causal, q_positions=qpos,
                       kv_len=kv_len, kv_start=kv_start).double()
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    kp = torch.arange(s)
    for r in range(b):
        kvs, kvl = int(kv_start[r]), min(int(kv_len[r]), s)
        vis = (kp[None] >= kvs) & (kp[None] < kvl)
        if causal:
            vis = vis & (kp[None] <= qpos[r][:, None])
        for h in range(hq):
            kh = h // g
            sc = (q[r, :, h] @ k[r, :, kh].T) * scale
            p = torch.where(vis, torch.exp(sc - lse[r, h][:, None]),
                            torch.zeros_like(sc))
            o = p @ v[r, :, kh]
            delta = (dout[r, :, h] * o).sum(-1)
            dp = dout[r, :, h] @ v[r, :, kh].T
            ds = p * (dp - delta[:, None])
            for q0 in range(0, t, b4b.Q_TILE):
                rows = slice(q0, q0 + b4b.Q_TILE)
                walked = torch.zeros(s, dtype=torch.bool)
                live = qpos[r, rows]
                for kt in b4.key_tiles(int(live.min()), int(live.max()), kvs,
                                       kvl, causal=causal, window=None):
                    walked[kt:kt + b4b.K_TILE] = True
                assert not (vis[rows] & ~walked[None]).any()
                dq[r, rows, h] = scale * (ds[rows][:, walked]
                                          @ k[r, walked, kh])
        for kh in range(hkv):
            for k0 in range(0, s, b4b.K_TILE):
                keys = slice(k0, k0 + b4b.K_TILE)
                tiles = b4b.query_tiles(k0, qpos[r].tolist(), kvs, kvl,
                                        causal=causal)
                for h in range(kh * g, (kh + 1) * g):
                    sc = (q[r, :, h] @ k[r, :, kh].T) * scale
                    p = torch.where(vis, torch.exp(sc - lse[r, h][:, None]),
                                    torch.zeros_like(sc))
                    delta = (dout[r, :, h] * (p @ v[r, :, kh])).sum(-1)
                    ds = p * (dout[r, :, h] @ v[r, :, kh].T - delta[:, None])
                    seen = torch.zeros(t, dtype=torch.bool)
                    for q0 in tiles:
                        seen[q0:q0 + b4b.Q_TILE] = True
                    assert not (vis[:, keys] & ~seen[:, None]).any()
                    dv[r, keys, kh] += p[seen][:, keys].T @ dout[r, seen, h]
                    dk[r, keys, kh] += scale * (ds[seen][:, keys].T
                                                @ q[r, seen, h])
    return dq, dk, dv


@pytest.mark.parametrize("t,g,causal", [(63, 1, True), (130, 4, True),
                                        (100, 2, False)])
def test_flash_bwd_tile_walks_match_plain(t, g, causal):
    """The backward kernels' walks (B4's ``key_tiles``, ``query_tiles``) leave
    no visible pair out, and their Delta formulation over the forward's
    lse gives autograd's gradients (the plain version): in float64 but for
    the lse, which is fp32 as the kernels read it, so within 1e-6 of each
    gradient's largest value; left padding on one row."""
    gen = torch.Generator().manual_seed(t)
    b, hkv, d = 2, 2, 16
    hq = hkv * g
    q, k, v, dout = (torch.randn(b, t, h, d, generator=gen).to(
        torch.bfloat16) for h in (hq, hkv, hkv, hq))
    kw = dict(scale=d ** -0.5, causal=causal,
              kv_len=torch.tensor([t, t - 7 if not causal else t],
                                  dtype=torch.int32),
              kv_start=torch.tensor([0, 29], dtype=torch.int32))
    qpos = torch.arange(t)[None].expand(b, t)
    want = b4b.flash_sdpa_bwd_plain(q.double(), k.double(), v.double(),
                                    dout.double(), q_positions=qpos, **kw)
    got = _emulate_flash_bwd(q, k, v, dout, qpos=qpos, **kw)
    for gv, wv in zip(got, want):
        assert float((gv - wv).abs().max()) <= 1e-6 * float(wv.abs().max())
    # the walk skips work: a causal key tile is not visited by the query
    # tiles wholly before it
    if causal and t > 64:
        assert b4b.query_tiles(64, list(range(t)), 0, t, causal=True) == \
            list(range(64, t, 64))


# -- B2^T (the dequant-matmul's input gradient) --------------------------------

@pytest.mark.parametrize("qtype", b2.FORMATS)
def test_qmatmul_dx_plan_fits_the_sm(qtype):
    """Two stages of a 128 x 128 bf16 dy tile and a step's packed planes,
    and one decoded 64 x 128 weight tile: under 100 KiB in every format,
    two blocks an SM; the grid covers dx [2048, K] at Llama-2-7B's
    shapes in 128 x 64 tiles, each walking N in steps of 128."""
    for k, n in LLAMA2_7B:
        p = b2t.plan(2048, n, k, qtype)
        assert p.grid == (16, k // 64) and p.steps == -(-n // 128)
        assert 2 * p.smem <= SMEM_SM and p.threads == 256
    # the stage planes agree with B2's tiled stage (csrc StagePlanes)
    assert b2t.stage_plane_bytes("sym_int4") == 32 * 128 + 2 * 128 * 2
    assert b2t.stage_plane_bytes("asym_int5") == (32 + 8) * 128 + 2 * 512
    assert b2t.stage_plane_bytes("fp8_e4m3") == 64 * 128 + 256


@pytest.mark.parametrize("qtype", ["sym_int4", "asym_int4", "nf4",
                                   "sym_int5", "fp8_e5m2"])
def test_qmatmul_dx_plain_matches_jax_vjp(qtype):
    """B2^T's plain version, ``dy @ dequant(W)^T`` over the padded rows
    and sliced to ``in_features``, against ``jax.vjp`` of the reference's
    oracle ``qmatmul_reference`` on the same packed weight: each dx row
    within one bf16 ulp of its largest value (both round the bf16 weight
    once; the vjp's fp32 sum and the plain version's float64 sum differ
    in the last place before the bf16 rounding)."""
    import jax

    rng = np.random.default_rng(4)
    k, n, m = 200, 96, 7               # K not a multiple of the block
    w = (rng.standard_normal((k, n)) / 10).astype(np.float32)
    ref_qt = ref_core.quantize(w, qtype)
    x = jnp.asarray(rng.standard_normal((m, k)), jnp.bfloat16)
    dy_j, dy_t = _bf16(rng.standard_normal((m, n)))
    _, vjp = jax.vjp(lambda a: qmatmul_reference(a, ref_qt), x)
    want = _f32(vjp(dy_j)[0])
    got = b2t.qmatmul_dx_plain(dy_t, _port_qtensor(ref_qt))[:, :k]
    err = np.abs(_f32(got) - want).max(axis=1)
    assert (err <= 2.0 ** -7 * np.abs(want).max(axis=1)).all()


# -- the (192, 128) instances: DeepSeek's MLA ----------------------------------

@pytest.mark.parametrize("r,hkv", [(8, 16), (1, 16), (8, 128), (1, 128)])
def test_ragged_split_plan_at_mla_widths(r, hkv):
    """B1's key split at G = 1, C = 1 (every MLA decode row: one kv head a
    query head), for V2-Lite's 16 heads and V3's 128 over 2048-slot rows
    of 128-slot pages: the rows' blocks reach about 1024 (or every page
    of the row has its own split), each split a whole number of pages;
    the (192, 128) plan keeps Q in registers, two staged pairs of a
    192-column K tile and a 128-column V tile, 80 KiB, two blocks an
    SM in either instance."""
    maxp, ps = 16, 128
    splits, pps = b1.split_plan(r, hkv, 1, maxp, ps)
    assert splits * pps >= maxp > (splits - 1) * pps
    assert r * hkv * splits >= min(1024, r * hkv * maxp)
    for split in (False, True):
        smem, q_smem = b1.smem_plan(192, split, 128)
        assert not q_smem and smem == 2 * 64 * (192 + 128) * 2 + 16
        assert 2 * (smem + 1024) <= SMEM_SM
        # the key split's warp merge ([4][16][Dv] fp32 and (m, l)) fits
        assert 4 * 16 * 128 * 4 + 4 * 16 * 8 <= smem


@pytest.mark.parametrize("fp8", [False, True])
def test_mla_ring_and_tile_plans_fit_the_sm(fp8):
    """B3's (192, 128) ring keeps one stage fewer than the (D, D) ones
    (two bf16 stages of 40 KiB pairs, or three raw e5m2 stages of 20 KiB
    and the widened pair), and B4's two stages of 40 KiB pairs: two blocks
    an SM for both; the (D, D) plans are those of before."""
    stages, smem, resident = b3.ring_plan(192, fp8, 128)
    assert (stages, smem, resident) == ((3, 100 * 1024, 2) if fp8
                                        else (2, 80 * 1024, 2))
    assert resident * (smem + 1024) <= SMEM_SM
    assert b3.ring_plan(128, fp8) == b3.ring_plan(128, fp8, 128)
    stages, smem, resident = b4.smem_plan(192, 128)
    assert (stages, smem, resident) == (2, 81 * 1024, 2)
    assert resident * (smem + 1024) <= SMEM_SM
    assert b4.smem_plan(256) == b4.smem_plan(256, 256)
    # the decode split at V2-Lite's 16 heads over 8 rows fills one wave
    assert b3.split_plan(8, 16, 4096, 192, 128) == 2 * 132 // 128


# -- the (64, 64), (96, 64) and (96, 96) instances: MiniCPM -------------------

PLANS_64 = {
    # (K, V): B1's block (either instance), B3's ring (bf16, e5m2) and its
    # stages, B4's ring, all in KiB (B1's plus its 16-byte slot)
    (64, 64): (32, (48, 48), (3, 4), 49),
    (96, 64): (48, (48, 60), (2, 3), 73),
    (96, 96): (64, (96, 96), (3, 4), 97),
}


@pytest.mark.parametrize("d,dv", sorted(PLANS_64))
def test_minicpm_plans_fit_the_sm(d, dv):
    """A 64-column row is eight 16-byte chunks, one period of the XOR
    swizzle, so the 64 instances stage native 64-column rows (8 KiB a
    tile); a 96-column K row keeps 128's width (the swizzle would carry
    chunks 8-11 out of a 12-chunk row).  B3's (96, 64) ring is the
    narrow-V ring, one stage fewer; every plan leaves room for the
    resident blocks and the key split's warp merge."""
    assert [b1.row_width(w) for w in (64, 80, 96, 128, 192, 256)] == \
        [64, 128, 128, 128, 192, 256]
    b1_kib, b3_kib, b3_stages, b4_kib = PLANS_64[(d, dv)]
    for split in (False, True):
        smem, q_smem = b1.smem_plan(d, split, dv)
        assert not q_smem and smem == b1_kib * 1024 + 16
        assert 4 * 16 * dv * 4 + 4 * 16 * 8 <= smem
    for fp8, kib, stages in zip((False, True), b3_kib, b3_stages):
        got = b3.ring_plan(d, fp8, dv)
        assert got == (stages, kib * 1024, 2)
        assert 2 * (got[1] + 1024) <= SMEM_SM
        assert 4 * 16 * dv * 4 + 4 * 16 * 8 <= got[1]
    stages, smem, resident = b4.smem_plan(d, dv)
    assert (stages, smem, resident) == (3, b4_kib * 1024, 2)
    assert resident * (smem + 1024) <= SMEM_SM
    assert all((d, dv) in mod.INSTANCES for mod in (b1, b3, b4))
