"""KV caches (port of ``ipex_llm_tpu/kv.py``).

Two forms, both in bf16 or ``torch.float8_e5m2`` storage:

- the dense head-major cache of ``generate()`` (:class:`KVCache`,
  :class:`Fp8KVCache`): one buffer per k/v of shape ``[L, B, Hkv, S, D]``
  (V ``Dv`` wide) and a filled-prefix ``length``, written at one uniform
  slot offset;
- the paged pool of the serving engine (:class:`PagedKVCache`): one pool
  per k/v of shape ``[L, P, Hkv, page, D]`` (V ``Dv`` wide) shared by
  every row, a per-row block table ``[R, maxP]`` of page ids (-1 =
  unallocated).  Page 0 is the engine's scratch page: writes past the
  table width or into unallocated slots land there.

V's width ``Dv`` is K's except under DeepSeek's MLA (K 192, V 128: the
reference's unbalanced cache).

Unlike the reference's immutable arrays, both are updated in place (the
cache is the largest buffer on the card; a copy per layer per step would
double its traffic), so ``update_layer`` returns the layer views it wrote,
and the dense cache's ``length`` is a Python int the decoder advances.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch

KV_STORAGE_DTYPES = {
    "bf16": torch.bfloat16,
    "fp8": torch.float8_e5m2,
}


def kv_storage_dtype(storage: str) -> torch.dtype:
    """Storage-format name -> pool dtype; raises listing the valid names."""
    try:
        return KV_STORAGE_DTYPES[storage]
    except KeyError:
        raise ValueError(
            f"unknown kv storage {storage!r}: valid storages are "
            f"{sorted(KV_STORAGE_DTYPES)}") from None


def paged_page_bytes(n_layers: int, n_kv_heads: int, page_size: int,
                     head_dim: int, v_head_dim: int | None = None,
                     storage: str = "bf16") -> int:
    """Bytes ONE page occupies across all layers and both k/v pools, K at
    ``head_dim`` and V at ``v_head_dim`` (None: K's) (the unit of the
    engine's ``kv_pool_bytes`` budget)."""
    vd = head_dim if v_head_dim is None else v_head_dim
    itemsize = torch.empty((), dtype=kv_storage_dtype(storage)).element_size()
    return n_layers * n_kv_heads * page_size * (head_dim + vd) * itemsize


def _write(layer: torch.Tensor, enc: torch.Tensor, index):
    """``layer[index] = enc`` in place; float8 layers write through a uint8
    view of the same bytes (the indexing kernels do not cover every float8
    dtype on every device)."""
    if enc.element_size() == 1:
        layer.view(torch.uint8)[index] = enc.view(torch.uint8)
    else:
        layer[index] = enc


@dataclass
class KVCache:
    """Dense head-major KV of ``generate()`` (the reference's ``KVCache``)."""

    k: torch.Tensor        # [L, B, Hkv, S_max, D] storage dtype
    v: torch.Tensor        # [L, B, Hkv, S_max, Dv]
    length: int = 0        # filled prefix, the same for every row
    storage: str = "bf16"

    @classmethod
    def init(cls, n_layers: int, batch: int, max_len: int, n_kv_heads: int,
             head_dim: int, v_head_dim: int | None = None,
             device=None) -> "KVCache":
        dtype = kv_storage_dtype(cls.storage)    # the class's default
        shape = (n_layers, batch, n_kv_heads, max_len)
        vd = head_dim if v_head_dim is None else v_head_dim
        return cls(k=torch.zeros(shape + (head_dim,), dtype=dtype,
                                 device=device),
                   v=torch.zeros(shape + (vd,), dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[3]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.k.dtype)

    def update_layer(self, kl: torch.Tensor, vl: torch.Tensor,
                     new_k: torch.Tensor, new_v: torch.Tensor, pos: int):
        """Write new_k/new_v [B, T, H, D] into the layer views [B, H, S, D]
        at slot ``pos`` (one uniform Python-int offset, the generate loop's
        invariant), in place."""
        if not isinstance(pos, int):
            raise NotImplementedError("per-row offsets into the dense cache "
                                      "are not ported (pass an int)")
        t = new_k.shape[1]
        if pos < 0 or pos + t > kl.shape[2]:
            raise ValueError(f"slots [{pos}, {pos + t}) outside the cache's "
                             f"{kl.shape[2]}")
        for layer, new in ((kl, new_k), (vl, new_v)):
            _write(layer, self.encode(new).transpose(1, 2),
                   (slice(None), slice(None), slice(pos, pos + t)))
        return kl, vl


@dataclass
class Fp8KVCache(KVCache):
    """e5m2 KV storage (the reference's ``Fp8KVCache``)."""

    storage: str = "fp8"


@dataclass
class PagedKVCache:
    """Block-table KV over a shared page pool (see the module docstring)."""

    k: torch.Tensor        # [L, P, Hkv, page, D]
    v: torch.Tensor        # [L, P, Hkv, page, Dv]
    tables: torch.Tensor   # [R, maxP] int32 page ids, -1 = unallocated
    storage: str = "bf16"

    @classmethod
    def init(cls, n_layers: int, n_pages: int, n_rows: int, max_pages: int,
             n_kv_heads: int, page_size: int, head_dim: int,
             storage: str = "bf16", device=None,
             v_head_dim: int | None = None) -> "PagedKVCache":
        dtype = kv_storage_dtype(storage)
        shape = (n_layers, n_pages, n_kv_heads, page_size)
        vd = head_dim if v_head_dim is None else v_head_dim
        return cls(
            k=torch.zeros(shape + (head_dim,), dtype=dtype, device=device),
            v=torch.zeros(shape + (vd,), dtype=dtype, device=device),
            tables=torch.full((n_rows, max_pages), -1, dtype=torch.int32,
                              device=device),
            storage=storage)

    @property
    def page_size(self) -> int:
        return self.k.shape[3]

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.k.dtype)

    def with_tables(self, tables: torch.Tensor) -> "PagedKVCache":
        """This pool (the same storage) seen through other block tables —
        the prefill stage's row-sliced view."""
        return PagedKVCache(self.k, self.v, tables, self.storage)

    def with_table_rows(self, rows: torch.Tensor,
                        table_rows: torch.Tensor) -> "PagedKVCache":
        """Replace only ``rows`` of the block table, in place."""
        self.tables[rows.long()] = table_rows.to(self.tables.dtype)
        return self

    def update_layer(self, kl: torch.Tensor, vl: torch.Tensor,
                     new_k: torch.Tensor, new_v: torch.Tensor,
                     pos: torch.Tensor):
        """Scatter new_k/new_v [B, T, H, D] into pool layer views
        [P, H, page, D] through the block table at per-row slot offsets
        ``pos`` [B] (in place).  Writes past the table width or into
        unallocated slots go to scratch page 0."""
        ps = self.page_size
        b, t = new_k.shape[:2]
        maxp = self.tables.shape[1]
        pos = pos.to(torch.int64)
        slots = pos[:, None] + torch.arange(t, device=pos.device)[None, :]
        page_idx = torch.div(slots, ps, rounding_mode="floor")
        rows = torch.arange(b, device=pos.device)[:, None]
        pages = self.tables[rows, page_idx.clamp(0, maxp - 1)].to(torch.int64)
        valid = (page_idx < maxp) & (pages >= 0)
        pages = torch.where(valid, pages, torch.zeros_like(pages))
        offs = slots % ps
        for layer, new in ((kl, new_k), (vl, new_v)):
            _write(layer, self.encode(new), (pages, slice(None), offs))
        return kl, vl

    def gather_layer(self, kl: torch.Tensor) -> torch.Tensor:
        """Pool layer [P, H, page, D] -> head-major rows [R, H, maxP*page, D]."""
        return gather_rows(kl, self.tables)


def gather_rows(pool_layer: torch.Tensor, tables: torch.Tensor
                ) -> torch.Tensor:
    """Each row's pages in table order: pool layer [P, H, page, D] and
    tables [R, maxP] -> [R, H, maxP*page, D], contiguous, in the pool's
    dtype (a float8 pool is gathered through a uint8 view of its bytes).
    Unallocated (-1) entries read scratch page 0; slots past a row's
    length are garbage the caller masks."""
    if pool_layer.is_floating_point() and pool_layer.element_size() == 1:
        return gather_rows(pool_layer.view(torch.uint8),
                           tables).view(pool_layer.dtype)
    r, maxp = tables.shape
    t = tables.long().clamp(0, pool_layer.shape[0] - 1)
    g = pool_layer[t].permute(0, 2, 1, 3, 4)        # [R, H, maxP, page, D]
    return g.reshape(r, g.shape[1], maxp * pool_layer.shape[2], g.shape[4])


# cache-kind registry: dense kinds take KVCache.init's signature, paged kinds
# PagedKVCache.init's (the serving pool)
CACHE_KINDS = {
    "normal": KVCache.init,
    "fp8": Fp8KVCache.init,
    "paged": PagedKVCache.init,
    "paged_fp8": lambda *a, **kw: PagedKVCache.init(*a, storage="fp8", **kw),
}


def make_cache(kind: str, *args, **kwargs):
    """kind: 'normal' | 'fp8' (dense) | 'paged' | 'paged_fp8' (pool)."""
    try:
        ctor = CACHE_KINDS[kind]
    except KeyError:
        raise ValueError(
            f"unknown kv cache kind {kind!r}: valid kinds are "
            f"{sorted(CACHE_KINDS)}") from None
    return ctor(*args, **kwargs)


def use_quantize_kv_cache() -> bool:
    """Opt-in gate for e5m2 KV: IPEX_LLM_TPU_QUANTIZE_KV_CACHE=1 (or the
    reference's IPEX_LLM_QUANTIZE_KV_CACHE); never on silently."""
    flag = os.environ.get("IPEX_LLM_TPU_QUANTIZE_KV_CACHE",
                          os.environ.get("IPEX_LLM_QUANTIZE_KV_CACHE", ""))
    return flag == "1"
