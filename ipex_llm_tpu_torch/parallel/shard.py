"""Tensor-parallel slicing rules, for one rank (port of
``ipex_llm_tpu/parallel/shard.py``).

The reference places the whole param tree on a mesh under named
shardings; the port hands each rank its own slices.  The rules are the
reference's ``_qtensor_spec``:

- qkv and gate_up are column-parallel: a rank holds ``out / tp`` columns
  of every plane;
- o and down are row-parallel: a rank holds ``in / tp`` contraction rows,
  in whole quantization blocks; the 5-bit formats (their bit plane has no
  contiguous row slice a rank) and a padded last block are refused;
- the lm head is column-parallel when the vocabulary divides;
- the paged pool splits its kv heads (:func:`shard_paged_cache`); with
  fewer kv heads than ranks it stays whole, and each rank reads the kv
  head its query heads attend to (:func:`kv_head_slice`; the attention
  wrappers take a rank's heads through :func:`rank_kv`).
"""

from __future__ import annotations

from ipex_llm_tpu_torch.quantize.core import QTensor

_COL = {"qkv", "gate_up", "moe_gate_up", "q_a", "kv_a"}
_ROW = {"o", "down", "moe_down"}
_COL_BIAS = {"qkv_bias", "gate_up_bias"}
_BIT5 = ("sym_int5", "asym_int5")


def _divisible(n: int, parts: int) -> bool:
    return parts > 0 and n % parts == 0


def tp_mode(qt: QTensor, kind: str, tp: int) -> str | None:
    """``"col"``, ``"row"`` or None: how ``qt`` (planes ``[(L,)? in_like,
    out]``) splits over ``tp`` ranks as a ``kind`` ("col", "row", "rep")
    weight, the mode the reference's ``_qtensor_spec`` stamps."""
    data_in = qt.data.shape[-2]
    nb = qt.scales.shape[-2] if qt.scales is not None else data_in
    if kind == "col" and _divisible(qt.out_features, tp):
        return "col" if tp > 1 else None
    if kind == "row" and _divisible(data_in, tp) and _divisible(nb, tp):
        bs = qt.block_size or 1
        if tp > 1 and qt.in_features % (bs * tp) == 0 \
                and qt.qtype not in _BIT5:
            return "row"
    return None


def shard_qtensor(qt: QTensor, mode: str | None, tp: int,
                  rank: int) -> QTensor:
    """Rank ``rank``'s slice of ``qt`` under ``mode`` (None: the whole
    weight): contiguous copies of its planes' columns (col) or rows
    (row)."""
    if mode is None:
        return qt
    if mode == "col":
        n = qt.out_features // tp
        return QTensor(*(None if t is None else
                         t[..., rank * n:(rank + 1) * n].contiguous()
                         for t in (qt.data, qt.scales, qt.zeros)),
                       qt.qtype, (qt.in_features, n), qt.block_size)
    if mode == "row":
        def rows(t):
            if t is None:
                return None
            n = t.shape[-2] // tp
            return t[..., rank * n:(rank + 1) * n, :].contiguous()
        return QTensor(rows(qt.data), rows(qt.scales), rows(qt.zeros),
                       qt.qtype, (qt.in_features // tp, qt.out_features),
                       qt.block_size)
    raise ValueError(f"tp mode {mode!r}")


def kv_head_slice(hq: int, hkv: int, tp: int, rank: int) -> tuple[int, int]:
    """(first kv head, kv head count) rank ``rank`` of ``tp`` reads, its
    query heads being the ``rank``-th ``hq / tp``: its ``hkv / tp`` heads
    when they divide, else (``tp % hkv == 0``, the reference's GQA repeat)
    the one kv head ``rank // (tp // hkv)``.  Other factorisations raise,
    as the reference's do."""
    if hq % tp:
        raise NotImplementedError("q heads must divide tp")
    if hkv % tp == 0:
        n = hkv // tp
        return rank * n, n
    if tp % hkv or (hq // hkv) % (tp // hkv):
        raise NotImplementedError("unsupported head/tp factorization")
    return rank // (tp // hkv), 1


def rank_kv(k, v, hq_local: int, tp: int, rank: int, n_kv_heads: int,
            axis: int = 1):
    """The kv heads of ``k``/``v`` rank ``rank`` of ``tp`` reads
    (:func:`kv_head_slice`, its query heads being ``hq_local``): as given
    when they hold just those (the rank's share of a pool or layer), else
    sliced on ``axis`` out of all ``n_kv_heads`` (the GQA repeat, where a
    rank's one kv head lies in the whole pool).  Any other head count
    raises."""
    h0, n = kv_head_slice(hq_local * tp, n_kv_heads, tp, rank)
    if k.shape[axis] == n:
        return k, v
    if k.shape[axis] != n_kv_heads or n_kv_heads % tp == 0:
        raise ValueError(f"rank {rank} of {tp}: {n} kv heads (or all "
                         f"{n_kv_heads}), got {k.shape[axis]}")
    return (k.narrow(axis, h0, n).contiguous(),
            v.narrow(axis, h0, n).contiguous())


def shard_paged_cache(cache, tp: int, rank: int):
    """Rank ``rank``'s pool: its kv heads of every ``[L, P, Hkv, page, D]``
    pool when they divide ``tp``, the whole pool otherwise; the block
    tables are shared."""
    from ipex_llm_tpu_torch.kv import PagedKVCache

    hkv = cache.k.shape[2]
    if tp <= 1 or not _divisible(hkv, tp):
        return cache
    n = hkv // tp
    return PagedKVCache(
        cache.k[:, :, rank * n:(rank + 1) * n].contiguous(),
        cache.v[:, :, rank * n:(rank + 1) * n].contiguous(),
        cache.tables, cache.storage)
