"""The dense-cache attention of the port against the JAX package.

The plain versions of B3 (``decode_sdpa``) and B4 (``flash_sdpa``), reached
through the port's wrappers on CPU tensors, are held against the JAX
kernels run in the Pallas interpreter (what ``_compat.interpret()``
selects off the TPU) on the same bf16 (or e5m2) inputs, and against the
JAX ``sdpa_reference`` on the rows that see a key.  Tolerance: every query
row (batch row and query, over heads and dims) within 2^-7 of that row's
largest |output|, the rule the card check holds the kernels to.  Both
sides round the output to bf16 once, so they may differ by one bf16 ulp of
an output (at most 2^-7 of the row's largest); the JAX kernel also rounds
p to bf16 before P.V, the plain version (float64) does not, which moves an
output by far less.  A query that sees no key gives 0 in the kernels and
in the plain versions; ``sdpa_reference`` gives the mean of V there, so
those rows are left out of that comparison.

The dense KV cache's writes are held byte for byte against the reference
cache's at a uniform slot offset, in bf16 and e5m2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipex_llm_tpu.kv import Fp8KVCache as RefFp8KVCache
from ipex_llm_tpu.kv import KVCache as RefKVCache
from ipex_llm_tpu.ops.attention import sdpa_reference as ref_sdpa
from ipex_llm_tpu.ops.pallas.decode_attention import decode_sdpa as ref_decode
from ipex_llm_tpu.ops.pallas.flash_attention import flash_sdpa as ref_flash
from ipex_llm_tpu_torch.kv import Fp8KVCache, KVCache, make_cache
from ipex_llm_tpu_torch.ops import attention as port_attention
from ipex_llm_tpu_torch.ops.cuda import decode_attention as b3
from ipex_llm_tpu_torch.ops.cuda import flash_attention as b4
from tests.test_torch_quantize import to_bytes

ROW_TOL = 2.0 ** -7
KV_DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
             "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


def _pair(rng, shape, storage="bf16"):
    """The same values as a torch tensor and a JAX array of the storage
    type (bf16 and e5m2 both widen exactly to float32)."""
    t_dtype, j_dtype = KV_DTYPES[storage]
    t = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        t_dtype)
    return t, jnp.asarray(t.float().numpy()).astype(j_dtype)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def assert_rows_close(got, want, keep=None, what=""):
    """Per query row of [B, T, H, D]: max |got - want| <= ROW_TOL * max
    |want| (rows where ``keep`` [B, T] is False are skipped)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    err = np.abs(got - want).max(axis=(2, 3))
    top = np.abs(want).max(axis=(2, 3))
    ok = err <= ROW_TOL * top
    if keep is not None:
        ok |= ~keep
    bad = np.argwhere(~ok)
    assert not bad.size, (what, bad[:4].tolist(), err[~ok][:4],
                          top[~ok][:4])


# -- B3: decode attention ----------------------------------------------------

B3_CASES = {
    "plain": dict(),
    "window cuts": dict(window=48),
    "window per row": dict(window=48, window_on=[1, 0, 1]),
    "softcap": dict(softcap=30.0),
    "window and softcap": dict(window=48, softcap=30.0),
}


@pytest.mark.parametrize("storage", ["bf16", "e5m2"])
@pytest.mark.parametrize("case", sorted(B3_CASES))
def test_decode_sdpa_plain_matches_jax_kernel(storage, case):
    """GQA with 4 query heads per kv head at head_dim 128 over a 256-slot
    head-major cache; rows with left padding and ragged fill, one row that
    sees no key (kv_start == kv_len)."""
    kw = B3_CASES[case]
    rng = np.random.default_rng(5)
    b, s, hq, hkv, d = 3, 256, 8, 2, 128
    q_t, q_j = _pair(rng, (b, 1, hq, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d), storage)
    v_t, v_j = _pair(rng, (b, hkv, s, d), storage)
    kv_len = np.array([200, 256, 90], np.int32)
    kv_start = np.array([0, 37, 90], np.int32)
    won = np.asarray(kw.get("window_on", True))
    opts = dict(window=kw.get("window"), softcap=kw.get("softcap"))

    before = b3.COUNTS.plain_calls
    got = b3.decode_sdpa(q_t, k_t, v_t, kv_len=torch.from_numpy(kv_len),
                         kv_start=torch.from_numpy(kv_start),
                         window_on=torch.from_numpy(won), **opts)
    assert b3.COUNTS.plain_calls == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, 1, hq, d)
    if won.ndim == 0:
        # the JAX kernel reads the enable flag of row 0 for every row
        # (``won_ref[0]``), so a per-row vector is held against the oracle
        # alone
        want = ref_decode(q_j, k_j, v_j, kv_len=jnp.asarray(kv_len),
                          kv_start=jnp.asarray(kv_start),
                          window_on=jnp.asarray(won), **opts)
        assert_rows_close(got, want, what=f"{storage} {case} vs decode_sdpa")
    assert not got[2].any(), "a row with no visible key gives 0"

    oracle = ref_sdpa(q_j, k_j.transpose(0, 2, 1, 3).astype(jnp.bfloat16),
                      v_j.transpose(0, 2, 1, 3).astype(jnp.bfloat16),
                      causal=True, q_positions=jnp.asarray(kv_len - 1)[:, None],
                      kv_len=jnp.asarray(kv_len),
                      kv_start=jnp.asarray(kv_start),
                      window_on=jnp.asarray(won)[..., None, None, None]
                      if won.ndim else won, **opts)
    assert_rows_close(got, oracle, keep=(kv_start < kv_len)[:, None],
                      what=f"{storage} {case} vs sdpa_reference")


def test_decode_sdpa_refuses_what_it_does_not_take():
    q = torch.zeros(1, 2, 4, 128, dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 16, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        b3.decode_sdpa(q, kv, kv)                      # T != 1
    with pytest.raises(NotImplementedError):
        b3.decode_sdpa(q[:, :1, :3], kv, kv)           # Hq % Hkv
    with pytest.raises(ValueError):
        b3.decode_sdpa(q[:, :1], kv, kv, window=0)


def test_decode_split_plan_covers_the_cache():
    """The kernel's splits of each row's visible range cover it from its
    first visible slot to kv_len exactly once, over the whole capacity
    too, and at the generate phase's shapes fill one wave of the blocks
    the card holds at once (2 an SM on 132 SMs; one more split would not
    fit)."""
    for b, hkv, s in ((4, 8, 2304), (1, 8, 4864), (1, 2, 128), (64, 32, 256),
                      (4, 8, 100)):
        splits = b3.split_plan(b, hkv, s)
        assert 1 <= splits <= min(64, -(-s // 64))
        kv_len = torch.tensor([s, s // 2 + 1, 1, s][:b] + [s] * (b - 4))
        kv_start = torch.tensor([0, 3, 1, s - 7][:b] + [0] * (b - 4))
        won = torch.ones(b, dtype=torch.int32)
        lo = b3.first_visible(kv_len, kv_start, won, None)
        start, end = b3.split_bounds(lo, kv_len, splits)
        for r in range(b):
            covered = [k for a, e in zip(start[r].tolist(), end[r].tolist())
                       for k in range(a, e)]
            assert covered == list(range(int(lo[r]), int(kv_len[r])))
    for b, s in ((4, 2304), (1, 4864)):
        blocks = b3.split_plan(b, 8, s) * b * 8
        assert 2 * 132 - b * 8 < blocks <= 2 * 132


# -- B4: flash attention ------------------------------------------------------

def _flash_case(name):
    """(kwargs as numpy, B, T, S): dense prefill rows left padded in a
    cache of capacity S > T, a chunk at later slots, and a non-causal
    form."""
    b, t, s = 3, 96, 160
    base = dict(causal=True, q_positions=np.broadcast_to(
        np.arange(t, dtype=np.int32)[None], (b, t)).copy(),
        kv_len=np.full((b,), t, np.int32),
        kv_start=np.array([0, 30, 70], np.int32))
    if name == "left padded":
        return base, b, t, s
    if name == "window cuts":
        return {**base, "window": 24}, b, t, s
    if name == "window per row":
        return {**base, "window": 24,
                "window_on": np.array([1, 0, 1], np.int32)}, b, t, s
    if name == "softcap":
        return {**base, "window": 24, "softcap": 30.0}, b, t, s
    if name == "chunk after a prefix":
        tc = 32
        return dict(causal=True, q_positions=np.broadcast_to(
            np.arange(tc, dtype=np.int32)[None] + (s - 48), (b, tc)).copy(),
            kv_len=np.full((b,), s - 16, np.int32),
            kv_start=np.array([0, 8, 100], np.int32), window=64), b, tc, s
    if name == "non-causal":
        return dict(causal=False, kv_len=np.array([s, s - 40, 77], np.int32),
                    kv_start=np.array([0, 11, 3], np.int32)), b, t, s
    raise KeyError(name)


FLASH_CASES = ["left padded", "window cuts", "window per row", "softcap",
               "chunk after a prefix", "non-causal"]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_sdpa_plain_matches_jax_kernel(case):
    """GQA (8 query heads over 2 kv heads) at head_dim 128; K/V reach the
    port as the dense cache holds them, a [B, S, Hkv, D] view of the
    head-major layer.  Pad queries see no key and give 0."""
    kw, b, t, s = _flash_case(case)
    rng = np.random.default_rng(7)
    hq, hkv, d = 8, 2, 128
    q_t, q_j = _pair(rng, (b, t, hq, d))
    k_t, k_j = _pair(rng, (b, hkv, s, d))
    v_t, v_j = _pair(rng, (b, hkv, s, d))
    k_j, v_j = k_j.transpose(0, 2, 1, 3), v_j.transpose(0, 2, 1, 3)

    before = b4.COUNTS.plain_calls
    got = port_attention.sdpa(
        q_t, k_t.transpose(1, 2), v_t.transpose(1, 2),
        **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()})
    assert b4.COUNTS.plain_calls == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (b, t, hq, d)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
           for k, v in kw.items()}
    assert_rows_close(got, ref_flash(q_j, k_j, v_j, **jkw),
                      what=f"{case} vs flash_sdpa")

    if "window_on" in jkw:
        jkw["window_on"] = jkw["window_on"][:, None, None, None]
    visible = b4.visible_queries(
        torch.from_numpy(kw.get("q_positions", np.zeros((b, t), np.int32))
                         ).long(),
        torch.from_numpy(kw["kv_len"]), torch.from_numpy(kw["kv_start"]),
        torch.from_numpy(np.broadcast_to(kw.get("window_on", 1), (b,))
                         .astype(np.int32)), causal=kw["causal"],
        window=kw.get("window"), s=s).numpy()
    assert not got.float().numpy()[~visible].any()
    assert_rows_close(got, ref_sdpa(q_j, k_j, v_j, **jkw), keep=visible,
                      what=f"{case} vs sdpa_reference")


def test_sdpa_refuses_a_bias():
    q = torch.zeros(1, 4, 2, 128, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError):
        port_attention.sdpa(q, q, q, bias=torch.zeros(1, 1, 4, 4))


# -- the dense KV cache -------------------------------------------------------

@pytest.mark.parametrize("storage", ["bf16", "fp8"])
def test_dense_cache_writes_match_reference_bytes(storage):
    """A prefill write of T slots at offset 0, then two single-slot writes,
    land in the same bytes as the reference cache's at the same uniform
    offsets (bf16 input, e5m2 rounding to nearest even on both sides)."""
    rng = np.random.default_rng(9)
    n_l, b, s, h, d = 2, 3, 24, 2, 16
    kind = "normal" if storage == "bf16" else "fp8"
    ref_cls = RefKVCache if storage == "bf16" else RefFp8KVCache
    ref = ref_cls.init(n_l, b, s, h, d)
    port = make_cache(kind, n_l, b, s, h, d, device="cpu")
    assert isinstance(port, Fp8KVCache if storage == "fp8" else KVCache)
    assert port.max_len == s and port.length == 0
    ref_k, ref_v = ref.k[1], ref.v[1]
    for pos, t in ((0, 10), (10, 1), (11, 1)):
        k_t, k_j = _pair(rng, (b, t, h, d))
        v_t, v_j = _pair(rng, (b, t, h, d))
        ref_k, ref_v = ref.update_layer(ref_k, ref_v, k_j, v_j,
                                        jnp.asarray(pos, jnp.int32))
        kl, vl = port.update_layer(port.k[1], port.v[1], k_t, v_t, pos)
        assert kl.data_ptr() == port.k[1].data_ptr()     # written in place
        assert to_bytes(port.k[1]) == to_bytes(np.asarray(ref_k))
        assert to_bytes(port.v[1]) == to_bytes(np.asarray(ref_v))
    assert not port.k[0].float().any()
    with pytest.raises(ValueError):
        port.update_layer(port.k[0], port.v[0], k_t, v_t, s)
    with pytest.raises(NotImplementedError):
        port.update_layer(port.k[0], port.v[0], k_t, v_t,
                          torch.zeros(b, dtype=torch.int32))


def test_make_cache_kinds():
    assert make_cache("paged_fp8", 1, 5, 2, 2, 2, 16, 8,
                      device="cpu").k.dtype == torch.float8_e5m2
    with pytest.raises(ValueError, match="valid kinds"):
        make_cache("compress", 1, 1, 8, 1, 8)
