"""The port's hand-written kernels on a card against their plain versions:
B5 (split paged attention) in both its tile heights, B2's GEMV (M <= 8)
and tiled (M > 8) instances in every block format, B2e (B2's tile over
rows sorted by expert) in every block format and row tile, B1 (ragged
paged attention) in both its instances
(query tiles, key split) at head_dim 64, 80, 96, 128 and 256, B3 (dense
decode attention) and B4 (flash attention) at head_dim 64, 80, 96, 128
and 256, all three at DeepSeek's K width 192 and V width 128, at
MiniCPM3's K width 96 and V width 64 and at Falcon-7B's GQA group of 71
(B3 also at 17 and 32, its groups of more than one 16-row tile) and, for
training, B4's LSE instance and backward and B2^T
(the dequant-matmul's input gradient).  Every case carries the ``cuda``
marker and
skips without a card.  The file imports neither JAX nor the JAX package,
so it runs where they are not installed; on a machine with a card:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``chip_smoke.py`` holds every kernel at the main paths' full widths.)
"""

import math

import pytest
import torch

from ipex_llm_tpu_torch.ops.cuda import _build
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from ipex_llm_tpu_torch.ops.cuda import flash_attention_bwd as b4b
from ipex_llm_tpu_torch.ops.cuda import paged_attention as b5
from ipex_llm_tpu_torch.ops.cuda import qmatmul as b2
from ipex_llm_tpu_torch.ops.cuda import qmatmul_dx as b2t
from ipex_llm_tpu_torch.ops.cuda import qmatmul_experts as b2e
from ipex_llm_tpu_torch.ops.cuda import ragged_paged_attention as b1
from ipex_llm_tpu_torch.quantize.core import QTensor, quantize
from ipex_llm_tpu_torch.quantize.qtypes import resolve

ULP = 2.0 ** -7         # one bf16 ulp, relative to a row's largest output
# the softcap cases scale q so that scores (N(0, 1) from randn q and k at
# scale d^-0.5) spread as N(0, 24^2) and pass the cap of 50
CAP_Q = 24.0


def _b5_case(storage: str, c: int, gen, g: int = 4):
    """Rows of 0 to 96 slots (C <= 4) or to 333 (wider chunks) over 32-slot
    pages, -1 past each row's last page; rows shorter than C (their early
    queries see no key) and one empty row."""
    wide = c > 4
    r, hkv, d, ps, maxp = 6, 2, 128, 32, 11 if wide else 3
    dtype = torch.bfloat16 if storage == "bf16" else torch.float8_e5m2
    n_pages = 1 + r * maxp
    k = torch.randn(n_pages, hkv, ps, d, generator=gen).to(dtype)
    v = torch.randn(n_pages, hkv, ps, d, generator=gen).to(dtype)
    kv_len = torch.tensor([1, 100, 130, 200, 0, 333] if wide
                          else [1, 2, 37, 96, 0, 50], dtype=torch.int32)
    tables = (1 + torch.randperm(r * maxp, generator=gen)).to(
        torch.int32).reshape(r, maxp)
    for i in range(r):
        tables[i, -(-int(kv_len[i]) // ps):] = -1
    q = torch.randn(r, c, hkv * g, d, generator=gen).to(torch.bfloat16)
    return q, k, v, tables, kv_len


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 4, 16, 128])
def test_paged_attention_kernel_matches_plain(storage, c):
    """Two launches (the page-split pass and the merge), G = 4: one
    16-row block per split at C = 1 and 4 (G*C <= 16), 64-row tiles at C =
    16 and 128; every query row within one bf16 ulp of its largest plain
    output, exact zeros where a query sees no key, and the same bits on a
    second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _b5_case(storage, c, torch.Generator().manual_seed(c))
    fn = b5.paged_decode_sdpa if c == 1 else b5.paged_prefill_sdpa
    want = fn(*args).float()
    b5.COUNTS.reset()
    got_t = fn(*[t.cuda() for t in args])
    assert b5.COUNTS.launches == 2 and b5.COUNTS.plain_calls == 0
    got = got_t.float().cpu()
    top = want.abs().amax(dim=(2, 3), keepdim=True)
    assert ((got - want).abs() <= ULP * top).all()
    assert not got[want.abs().amax(dim=(2, 3)) == 0].any()
    assert torch.equal(fn(*[t.cuda() for t in args]), got_t)


# (K, N): N % 16 == 0 (16-byte copies) and not (200, 1028: 4-byte copies),
# and shapes whose plans split K over 2 warps, 4 warps and clusters of up
# to 8 blocks
B2_GEMV_SHAPES = ((256, 384), (224, 200), (1024, 1040), (4096, 1024),
                  (2048, 1028), (4096, 4096))


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", b2.FORMATS)
def test_qmatmul_gemv_kernel_matches_plain(qtype):
    """B2's GEMV instance at M = 1 to 8, bf16 and fp32 out: one launch a
    call, each output row within one bf16 ulp of its largest plain output,
    and the same bits on a second call (the splits meet in a fixed
    order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(11)
    bs = resolve(qtype).block_size
    for k, n in B2_GEMV_SHAPES:
        if k % bs:
            continue
        wq = quantize(torch.randn(k, n, generator=gen) / math.sqrt(k), qtype)
        wq_dev = wq.planes(lambda t: t.cuda())
        for m in (1, 2, 3, 4, 5, 8):
            x = torch.randn(m, k, generator=gen).to(torch.bfloat16)
            for keep_f32 in (False, True):
                want = b2.qmatmul_plain(x, wq, keep_f32=keep_f32).float()
                b2.COUNTS.reset()
                got = b2.qmatmul(x.cuda(), wq_dev, keep_f32=keep_f32)
                torch.cuda.synchronize()
                assert b2.COUNTS.launches == 1
                assert b2.COUNTS.by_route["gemv"] == 1
                assert b2.COUNTS.plain_calls == 0
                assert torch.equal(
                    b2.qmatmul(x.cuda(), wq_dev, keep_f32=keep_f32), got)
                got = got.float().cpu()
                top = want.abs().amax(dim=1, keepdim=True)
                assert ((got - want).abs() <= ULP * top).all(), (k, n, m)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", b2.FORMATS)
def test_qmatmul_tiled_kernel_matches_plain(qtype):
    """B2's tiled instance at ragged M (9 to 128), N a multiple of 16 and
    not (200: the 4-byte copies, a part-full column tile), K of whole
    blocks and with a half 64-row step (224, 32-row formats), bf16 and fp32
    out: each output row within one bf16 ulp of its largest plain output."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(7)
    for k, n in ((256, 384), (224, 200)):
        if k % resolve(qtype).block_size:
            continue
        wq = quantize(torch.randn(k, n, generator=gen) / math.sqrt(k), qtype)
        wq_dev = wq.planes(lambda t: t.cuda())
        for m in (9, 16, 17, 32, 100, 128):
            x = torch.randn(m, k, generator=gen).to(torch.bfloat16)
            for keep_f32 in (False, True):
                want = b2.qmatmul_plain(x, wq, keep_f32=keep_f32).float()
                b2.COUNTS.reset()
                got = b2.qmatmul(x.cuda(), wq_dev, keep_f32=keep_f32)
                torch.cuda.synchronize()
                assert b2.COUNTS.by_route["tiled"] >= 1
                assert b2.COUNTS.plain_calls == 0
                assert got.dtype == (torch.float32 if keep_f32
                                     else torch.bfloat16)
                got = got.float().cpu()
                top = want.abs().amax(dim=1, keepdim=True)
                assert ((got - want).abs() <= ULP * top).all(), (k, n, m)


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", b2.FORMATS)
@pytest.mark.parametrize("instance,counts,max_rows", [
    ("gemv", (0, 1, 7, 8, 9, 0), 8), ("gemv", (0, 0, 24, 0, 0, 0), 8),
    ("gemv", (1, 1, 1, 1, 1, 1), 8),
    ("wgmma", (0, 1, 130, 9, 300, 200), None),
    ("wgmma", (0, 0, 640, 0, 0, 0), None),
    ("tiled16", (4, 0, 9, 3, 0, 20), None),
    ("tiled64", (0, 1, 7, 8, 9, 130), None)],
    ids=["gemv-9rows", "gemv-one-expert", "gemv-1row", "wgmma-tails",
         "wgmma-one-expert", "tiled16", "tiled64"])
def test_qmatmul_experts_kernel_matches_plain(qtype, instance, counts,
                                              max_rows):
    """Each instance of B2e over 6 experts (the gemv instance under a bound
    of 8 rows an expert, which the first two splits break and the kernel
    must take all the same; wgmma at 64 or more rows an expert with ragged
    segment tails; the tiled instance's 16- and 64-row tiles), K = 200
    padded to the format's block, N a multiple of 16 and not, bf16 and
    fp32 out: one launch of that instance a call, each output row within
    one bf16 ulp of its largest plain output, and the same bits on a
    second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(5)
    bs = resolve(qtype).block_size
    k = -(-200 // bs) * bs
    seg = torch.zeros(7, dtype=torch.int32)
    seg[1:] = torch.cumsum(torch.tensor(counts), 0)
    for n in (384, 200):
        qts = [quantize(torch.randn(200, n, generator=gen) / math.sqrt(200),
                        qtype) for _ in range(6)]

        def st(key):
            planes = [getattr(q, key) for q in qts]
            return None if planes[0] is None else torch.stack(planes)
        qt = QTensor(st("data"), st("scales"), st("zeros"), qtype, (200, n),
                     bs)
        qt_dev = qt.planes(lambda t: t.cuda())
        x = torch.zeros(sum(counts), k, dtype=torch.bfloat16)
        x[:, :200] = torch.randn(sum(counts), 200, generator=gen)
        for keep_f32 in (False, True):
            want = b2e.qmatmul_experts_plain(x, seg, qt,
                                             keep_f32=keep_f32).float()
            b2e.COUNTS.reset()
            got = b2e.qmatmul_experts(x.cuda(), seg.cuda(), qt_dev,
                                      keep_f32=keep_f32, max_rows=max_rows)
            torch.cuda.synchronize()
            key = f"{instance}/{'f32' if keep_f32 else 'bf16'}"
            assert b2e.COUNTS.launches == 1 and b2e.COUNTS.plain_calls == 0
            assert b2e.COUNTS.by_instance[key] == 1
            assert torch.equal(b2e.qmatmul_experts(
                x.cuda(), seg.cuda(), qt_dev, keep_f32=keep_f32,
                max_rows=max_rows), got)
            got = got.float().cpu()
            top = want.abs().amax(dim=1, keepdim=True)
            assert ((got - want).abs() <= ULP * top).all(), (n, keep_f32)


def _b1_case(storage: str, c: int, g: int, gen, d: int = 128,
             dv: int | None = None):
    """Rows at staggered lengths over 32-slot pages in random order, -1
    past each row's last page; a decode row, chunk rows (one shorter than
    its history allows, one full), and an idle row with the sentinel
    kv_len past the table."""
    r, hkv, ps, maxp = 5, 2, 32, 6
    dtype = torch.bfloat16 if storage == "bf16" else torch.float8_e5m2
    n_pages = 1 + r * maxp
    k = torch.randn(n_pages, hkv, ps, d, generator=gen).to(dtype)
    v = torch.randn(n_pages, hkv, ps, dv or d, generator=gen).to(dtype)
    chunk = torch.tensor([1, c, max(1, c // 2), c, 0], dtype=torch.int32)
    kv_len = torch.tensor([150, 190, 41, c, maxp * ps], dtype=torch.int32)
    tables = (1 + torch.randperm(r * maxp, generator=gen)).to(
        torch.int32).reshape(r, maxp)
    for i in range(r - 1):
        tables[i, -(-int(kv_len[i]) // ps):] = -1
    tables[-1] = -1
    q = torch.randn(r, c, hkv * g, d, generator=gen).to(torch.bfloat16)
    return q, k, v, tables, kv_len, chunk


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("c", [1, 2, 4, 16, 128])
def test_ragged_attention_kernel_matches_plain(storage, g, c):
    """Both instances (G*C <= 16: key split and merge, two launches; else
    query tiles, one): every valid query row within one bf16 ulp of its
    largest plain output, the idle row exact zeros, pad queries finite."""
    _ragged_case(storage, g, c, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 2, 4, 128])
def test_ragged_attention_group_16_matches_plain(storage, c):
    """The 128 instances at GLM-4-9B's GQA group of 16 (32 query heads
    over 2 kv heads): at C = 1 the key split's 16 rows are 16 query heads
    of one kv head; C = 2 and the verify chunk C = 4 take the query tiles
    (32 and 64 rows), as does C = 128."""
    _ragged_case(storage, 16, c, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("c", [1, 4, 16, 128])
def test_ragged_attention_head_dim_256_matches_plain(storage, g, c):
    """B1's head_dim-256 instances (query rows in shared memory, one block
    an SM) on the cases of the 128 ones, at Gemma-7B's group of 1 and
    Gemma-3-4B's of 2: the key split at C = 1 and 4 (and 16 at G = 1),
    the query tiles above."""
    _ragged_case(storage, g, c, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("c", [1, 4, 16, 128])
def test_ragged_attention_head_dim_80_matches_plain(storage, g, c):
    """B1's head_dim-80 instances (Phi-2's width: rows 128 columns wide in
    shared memory, 80 of them staged and read) on the cases of the 128
    ones, at Phi-2's group of 1 and at 4."""
    _ragged_case(storage, g, c, 80)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 4, 16, 128])
def test_ragged_attention_head_dim_192_matches_plain(storage, c):
    """B1's (192, 128) instances (DeepSeek's MLA: K 192 wide, V 128, one
    kv head a query head) on the cases of the 128 ones: the key split at
    C = 1, 4 and 16, the query tiles at 128; the output 128 wide."""
    _ragged_case(storage, 1, c, 192, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("c", [1, 4, 16, 128])
def test_ragged_attention_head_dim_64_matches_plain(storage, g, c):
    """B1's head_dim-64 instances (MiniCPM-2B's width, and Llama-3.2-1B's
    at G = 4: native 64-column rows, one period of the swizzle) on the
    cases of the 128 ones."""
    _ragged_case(storage, g, c, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("c", [1, 4, 16, 128])
def test_ragged_attention_head_dim_96_matches_plain(storage, g, c):
    """B1's (96, 96) instances (rows 128 columns wide, 96 staged) on the
    cases of the 128 ones."""
    _ragged_case(storage, g, c, 96)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 4, 16, 128])
def test_ragged_attention_head_dim_96_64_matches_plain(storage, c):
    """B1's (96, 64) instances (MiniCPM3's MLA: K 96 wide in 128-column
    rows, V 64 in native rows, one kv head a query head) on the cases of
    the 128 ones; the output 64 wide."""
    _ragged_case(storage, 1, c, 96, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("c", [1, 4, 128])
def test_ragged_attention_group_71_matches_plain(storage, c):
    """The 64 instances at Falcon-7B's GQA group of 71: G*C is above the
    key split's 16 rows at every C, so decode (71 rows), the verify chunk
    (284) and a chunk of 128 (9088) take the query tiles, two 64-row
    tiles a decode row."""
    _ragged_case(storage, 71, c, 64)


def _ragged_case(storage, g, c, d, dv=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = _b1_case(storage, c, g, torch.Generator().manual_seed(
        10 * c + g + d), d, dv)
    want = b1.ragged_paged_sdpa(*args).float()
    b1.COUNTS.reset()
    got = b1.ragged_paged_sdpa(*[t.cuda() for t in args]).float().cpu()
    split = g * c <= 16
    assert b1.COUNTS.launches == (2 if split else 1)
    assert b1.COUNTS.by_route["split" if split else "tiles"] == \
        b1.COUNTS.launches == b1.COUNTS.by_head_dim[d]
    assert b1.COUNTS.plain_calls == 0
    assert torch.isfinite(got).all() and got.shape == want.shape
    assert got.shape[-1] == (dv or d)
    for i, n in enumerate(args[5].tolist()):
        if n == 0:
            assert not got[i].any()
            continue
        top = want[i, :n].abs().amax(dim=(1, 2), keepdim=True)
        assert ((got[i, :n] - want[i, :n]).abs() <= ULP * top).all(), i


def _rows_close(got, want, what=""):
    """Each query row of [B, T, H, D] within one bf16 ulp of its largest
    plain output; a row whose plain output is 0 (no visible key) is 0."""
    assert torch.isfinite(got).all(), what
    top = want.abs().amax(dim=(2, 3), keepdim=True)
    bad = ((got - want).abs() > ULP * top).any(dim=(2, 3))
    assert not bad.any(), (what, bad.nonzero()[:4].tolist())


def _cap_binds(want, uncapped):
    """The softcap moves some row's plain output by ten ulps of its
    largest value, so a kernel that left it out would fail."""
    top = want.abs().amax(dim=(2, 3)).clamp_min(1e-30)
    gap = ((want - uncapped).abs().amax(dim=(2, 3)) / top).max()
    assert gap > 10 * ULP, gap


B3_VARIANTS = {"plain": {}, "window": dict(window=100),
               "softcap": dict(softcap=50.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("variant", sorted(B3_VARIANTS))
def test_decode_attention_kernel_matches_plain(storage, g, variant):
    """B3 over a 700-slot head-major cache (not a multiple of the 64-key
    tile): ragged kv_len (700, 333, 65, 1, 150), left padding (kv_start 37,
    64, 100), a row that sees no key (kv_start == kv_len), and with the
    100-slot window, which cuts, a per-row enable vector (off on row 2).
    Two launches (split pass, merge), each row within one bf16 ulp of its
    largest plain output, the empty row exact zeros.  The softcap case
    scales q by CAP_Q so that the cap of 50 binds.  G = 16 (GLM-4-9B's)
    fills the 16-row tile."""
    _decode_case(storage, g, variant, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 2, 7, 16])
@pytest.mark.parametrize("variant", sorted(B3_VARIANTS))
def test_decode_attention_head_dim_256_matches_plain(storage, g, variant):
    """B3's head_dim-256 instance (query rows in shared memory, one block
    an SM) on the cases of the 128 instance, at GQA groups up to the full
    16-row tile."""
    _decode_case(storage, g, variant, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("variant", sorted(B3_VARIANTS))
def test_decode_attention_head_dim_96_matches_plain(storage, g, variant):
    """B3's head_dim-96 instance (the 128 instance's tile layout, 96 of
    its 128 columns staged and read) on the cases of the 128 instance, at
    Phi-3-mini's group of 1 and at 4."""
    _decode_case(storage, g, variant, 96)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("variant", sorted(B3_VARIANTS))
def test_decode_attention_head_dim_80_matches_plain(storage, g, variant):
    """B3's head_dim-80 instance (the 96 one at 80 columns: five score
    steps, ten output tiles, a 96-thread merge) on the cases of the 128
    instance, at Phi-2's group of 1 and at 4."""
    _decode_case(storage, g, variant, 80)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("variant", sorted(B3_VARIANTS))
def test_decode_attention_head_dim_192_matches_plain(storage, variant):
    """B3's (192, 128) instance (K 192, V 128, one stage fewer) on the
    cases of the 128 instance at DeepSeek's group of 1."""
    _decode_case(storage, 1, variant, 192, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("variant", sorted(B3_VARIANTS))
def test_decode_attention_head_dim_64_matches_plain(storage, g, variant):
    """B3's head_dim-64 instance (native 64-column rows, four score
    steps, a 64-thread merge) on the cases of the 128 instance, at
    MiniCPM-2B's group of 1 and Llama-3.2-1B's of 4."""
    _decode_case(storage, g, variant, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("variant", sorted(B3_VARIANTS))
def test_decode_attention_head_dim_96_64_matches_plain(storage, variant):
    """B3's (96, 64) instance (MiniCPM3: K rows 128 columns wide, V rows
    64, one stage fewer) on the cases of the 128 instance at G = 1."""
    _decode_case(storage, 1, variant, 96, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("d,g", [(64, 17), (64, 32), (64, 71), (128, 17),
                                 (128, 32), (128, 71)])
@pytest.mark.parametrize("variant", sorted(B3_VARIANTS))
def test_decode_attention_group_above_16_matches_plain(storage, d, g,
                                                       variant):
    """B3 past one 16-row tile: G = 17 (a tile of one row beside a full
    one), 32 (two full tiles) and Falcon-7B's 71 (five tiles, the last of
    7 rows) at head_dim 64 and 128, on the cases of the 128 instance."""
    _decode_case(storage, g, variant, d)


def _decode_case(storage, g, variant, d, dv=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(100 * g + len(variant) + d)
    b, hkv, s = 5, 2, 700
    dtype = torch.bfloat16 if storage == "bf16" else torch.float8_e5m2
    q = (torch.randn(b, 1, hkv * g, d, generator=gen)
         * (CAP_Q if variant == "softcap" else 1.0)).to(torch.bfloat16)
    k = torch.randn(b, hkv, s, d, generator=gen).to(dtype)
    v = torch.randn(b, hkv, s, dv or d, generator=gen).to(dtype)
    kw = dict(kv_len=torch.tensor([700, 333, 65, 1, 150], dtype=torch.int32),
              kv_start=torch.tensor([0, 37, 64, 1, 100], dtype=torch.int32),
              window_on=torch.tensor([1, 1, 0, 1, 1], dtype=torch.int32),
              **B3_VARIANTS[variant])
    want = b3.decode_sdpa(q, k, v, **kw).float()
    if variant == "softcap":
        _cap_binds(want, b3.decode_sdpa(q, k, v, **{**kw, "softcap": None}))
    b3.COUNTS.reset()
    got = b3.decode_sdpa(q.cuda(), k.cuda(), v.cuda(),
                         **{n: x.cuda() if isinstance(x, torch.Tensor) else x
                            for n, x in kw.items()}).float().cpu()
    assert b3.COUNTS.launches == 2 and b3.COUNTS.plain_calls == 0
    _rows_close(got, want, f"{storage} G={g} {variant}")
    assert not got[3].any() and not want[3].any()


B4_VARIANTS = ("causal, window cuts", "softcap", "non-causal")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [200, 1000])
@pytest.mark.parametrize("g", [1, 4, 16])
@pytest.mark.parametrize("variant", B4_VARIANTS)
def test_flash_attention_kernel_matches_plain(t, g, variant):
    """B4 at T not a multiple of its 64-query tile, K/V read through the
    [B, S, Hkv, D] view of a head-major cache of T + 64 slots: left
    padding (row 1 starts at slot 77); causal with a 150-slot window that
    cuts; softcap 50 (causal, no window, q scaled by CAP_Q so that it
    binds); non-causal with kv_len < S on
    row 1.  One launch, each query row within one bf16 ulp of its largest
    plain output, rows that see no key exact zeros; at G = 1, 4 and 16
    (GLM-4-9B's group)."""
    _flash_case(t, g, variant, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 200, 1000])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("variant", B4_VARIANTS)
def test_flash_attention_head_dim_256_matches_plain(t, g, variant):
    """B4's head_dim-256 instance (Q through a descriptor, O in two
    128-column halves, two stages) on the cases of the 128 instance, and
    at T = 4, the verify width of speculation; the causal queries sit
    after 64 cached slots, as a verify chunk does."""
    _flash_case(t, g, variant, 256, lead=64)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 200, 1000])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("variant", B4_VARIANTS)
def test_flash_attention_head_dim_96_matches_plain(t, g, variant):
    """B4's head_dim-96 instance (tiles laid out 128 columns wide, the
    other 32 zeros in shared memory) on the cases of the 128 instance and
    at the verify width T = 4 after 64 cached slots."""
    _flash_case(t, g, variant, 96, lead=64)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 200, 1000])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("variant", B4_VARIANTS)
def test_flash_attention_head_dim_80_matches_plain(t, g, variant):
    """B4's head_dim-80 instance (the 96 one at 80 columns: the other 48
    of the 128-column tile zeros in shared memory) on the cases of the 128
    instance and at the verify width T = 4 after 64 cached slots."""
    _flash_case(t, g, variant, 80, lead=64)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 200, 1000])
@pytest.mark.parametrize("variant", B4_VARIANTS)
def test_flash_attention_head_dim_192_matches_plain(t, variant):
    """B4's (192, 128) instance (a 192-column K tile, a 128-column V tile,
    two stages; K and V through their own strides) on the cases of the 128
    instance at DeepSeek's group of 1, and at T = 4 after 64 cached
    slots."""
    _flash_case(t, 1, variant, 192, lead=64, dv=128)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 200, 1000])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("variant", B4_VARIANTS)
def test_flash_attention_head_dim_64_matches_plain(t, g, variant):
    """B4's head_dim-64 instance (native 64-column tiles: four score
    steps, O += P.V on one m64n64k16 per 16 keys) on the cases of the 128
    instance and at the verify width T = 4 after 64 cached slots."""
    _flash_case(t, g, variant, 64, lead=64)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 200, 1000])
@pytest.mark.parametrize("variant", B4_VARIANTS)
def test_flash_attention_head_dim_96_64_matches_plain(t, variant):
    """B4's (96, 64) instance (MiniCPM3: the 96 instance's K tile, the
    64 instance's V tile and P.V; K and V through their own strides) at
    G = 1, and at T = 4 after 64 cached slots."""
    _flash_case(t, 1, variant, 96, lead=64, dv=64)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 200])
@pytest.mark.parametrize("variant", B4_VARIANTS)
def test_flash_attention_group_71_matches_plain(t, variant):
    """B4's head_dim-64 instance at Falcon-7B's 71 query heads a kv head,
    on the cases of the 128 instance and at the verify width T = 4 after
    64 cached slots."""
    _flash_case(t, 71, variant, 64, lead=64)


def _flash_case(t, g, variant, d, lead=0, dv=None):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(t + g + d)
    b, hkv, s = 2, 2, t + 64
    q = (torch.randn(b, t, hkv * g, d, generator=gen)
         * (CAP_Q if variant == "softcap" else 1.0)).to(torch.bfloat16)
    k = torch.randn(b, hkv, s, d, generator=gen).to(torch.bfloat16)
    v = torch.randn(b, hkv, s, dv or d, generator=gen).to(torch.bfloat16)
    kw = dict(kv_start=torch.tensor([0, min(77, t - 1)], dtype=torch.int32),
              kv_len=torch.tensor([lead + t] * b, dtype=torch.int32),
              q_positions=lead + torch.arange(t)[None].expand(b, t))
    if variant == "causal, window cuts":
        kw["window"] = 150
    elif variant == "softcap":
        kw["softcap"] = 50.0
    else:
        kw.update(causal=False, kv_start=torch.tensor([0, 11],
                                                      dtype=torch.int32),
                  kv_len=torch.tensor([s, s - 40], dtype=torch.int32))
    want = b4.flash_sdpa(q, k.transpose(1, 2), v.transpose(1, 2),
                         **kw).float()
    if variant == "softcap":
        _cap_binds(want, b4.flash_sdpa(q, k.transpose(1, 2),
                                       v.transpose(1, 2),
                                       **{**kw, "softcap": None}))
    b4.COUNTS.reset()
    got = b4.flash_sdpa(q.cuda(), k.cuda().transpose(1, 2),
                        v.cuda().transpose(1, 2),
                        **{n: x.cuda() if isinstance(x, torch.Tensor) else x
                           for n, x in kw.items()}).float().cpu()
    assert b4.COUNTS.launches == 1 and b4.COUNTS.plain_calls == 0
    _rows_close(got, want, f"T={t} G={g} {variant}")
    assert not got[want.abs().amax(dim=(2, 3)) == 0].any()


# -- training: B4's LSE instance and backward, B2^T ---------------------------

BWD_ULP = 2.0 ** -6     # B4's backward: two more bf16 operands than B4


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 63, 200])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_matches_plain(t, g, causal):
    """B4's LSE instance (out and lse) and its backward (two launches) on
    T not a multiple of the 64-row tiles, left padding on row 1 (and
    kv_len < T there without causal masking): dQ per query row, dK and dV
    per key row within BWD_ULP of the row's largest plain value, or of
    2^-10 of the largest gradient where a row's exact gradient cancels
    to 0 (a query over one key); a second call bitwise the first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(t * 8 + g)
    b, hkv, d = 2, 2, 128
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen).to(torch.bfloat16)
                   for h in (hkv * g, hkv, hkv, hkv * g))
    kw = dict(scale=d ** -0.5, causal=causal,
              q_positions=torch.arange(t)[None].expand(b, t),
              kv_start=torch.tensor([0, min(37, t - 1)], dtype=torch.int32),
              kv_len=torch.tensor([t, t if causal else max(t - 9, 1)],
                                  dtype=torch.int32))
    cuda = {k_: (x.cuda() if isinstance(x, torch.Tensor) else x)
            for k_, x in kw.items()}
    out, lse = b4.flash_sdpa_lse(q.cuda(), k.cuda(), v.cuda(), **cuda)
    want_lse = b4.lse_plain(q, k, **kw)
    lse = lse.cpu()
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert float((lse[fin] - want_lse[fin]).abs().max()) < 1e-3
    grads = b4b.flash_sdpa_bwd(q.cuda(), k.cuda(), v.cuda(),
                               do.cuda(), lse.cuda(), **cuda)
    again = b4b.flash_sdpa_bwd(q.cuda(), k.cuda(), v.cuda(),
                               do.cuda(), lse.cuda(), **cuda)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(grads, again))
    want = b4b.flash_sdpa_bwd_plain(q, k, v, do, **kw)
    floor = 2.0 ** -10 * max(float(w.abs().max()) for w in want)
    for got, ref in zip(grads, want):
        err = (got.cpu().float() - ref.float()).abs().amax(dim=(2, 3))
        top = ref.float().abs().amax(dim=(2, 3)).clamp_min(floor)
        assert bool((err <= BWD_ULP * top).all())


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", b2.FORMATS)
@pytest.mark.parametrize("m,k,n", [(1, 256, 384), (130, 200, 200),
                                   (300, 4096, 1000)])
def test_qmatmul_dx_kernel_matches_plain(qtype, m, k, n):
    """B2^T at ragged M, K padded to the format's block, N a multiple of 8
    but not of 16 (4-byte plane copies) or of 16: each dx row within one
    bf16 ulp of its largest plain value, a second call bitwise the
    first."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    gen = torch.Generator().manual_seed(m + k + n)
    qt = quantize(torch.randn(k, n, generator=gen) * k ** -0.5, qtype)
    dy = torch.randn(m, n, generator=gen).to(torch.bfloat16)
    qt_dev = qt.planes(lambda t: t.cuda())
    got = b2t.qmatmul_dx(dy.cuda(), qt_dev)
    torch.cuda.synchronize()
    assert torch.equal(b2t.qmatmul_dx(dy.cuda(), qt_dev), got)
    want = b2t.qmatmul_dx_plain(dy, qt).float()
    err = (got.cpu().float() - want).abs().amax(dim=1)
    assert bool((err <= ULP * want.abs().amax(dim=1)).all())


# -- tensor parallelism: the sharded wrappers over two ranks on one card ------

@pytest.mark.cuda
def test_sharded_wrappers_match_the_unsharded_kernels(tmp_path):
    """B1s (key split at C = 1, query tiles at C = 64), B2s col and row
    (sym_int4, M = 1 and 40) and B4s over two gloo ranks on cuda:0: the
    ranks' head or column blocks, concatenated, and B2 row's sum on each
    rank, within one bf16 ulp of each row's largest value of the
    unsharded kernel on the same inputs; every wrapper launched its kernel
    and none ran a plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import pathlib
    import sys

    import numpy as np

    # by path: a machine may have another package named ``tests``
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    import torch_tp_ranks
    # built here, once, before the ranks start: their join timeout is not
    # meant to hold two nvcc runs of each source
    _build.build(_build.sources([b1, b2, b4]))
    got = torch_tp_ranks.spawn(torch_tp_ranks.cuda_sharded_rank, 2, tmp_path,
                               device="cuda:0", timeout_s=120.0)
    want = torch_tp_ranks.cuda_cases(torch.device("cuda", 0))
    for key, w in want.items():
        axis = {"b2 col": 1, "b1": 2, "b4": 2}.get(key.split(" M=")[0]
                                                   .split(" C=")[0])
        parts = [got[r][key] for r in range(2)]
        g = parts[0] if axis is None else np.concatenate(parts, axis=axis)
        if axis is None:
            np.testing.assert_array_equal(parts[0], parts[1])
        flat_g = g.reshape(g.shape[0] * (g.shape[1] if g.ndim > 2 else 1), -1)
        flat_w = w.reshape(flat_g.shape)
        err = np.abs(flat_g - flat_w).max(axis=1)
        assert (err <= ULP * np.abs(flat_w).max(axis=1)).all(), key
    for r in range(2):
        assert all(n > 0 for n in got[r]["launches"]) and not got[r]["plain"]
