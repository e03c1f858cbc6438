"""Paged KV pool (port of ``ipex_llm_tpu/kv.py::PagedKVCache``).

One pool per k/v of shape ``[L, P, Hkv, page, D]`` shared by every row, a
per-row block table ``[R, maxP]`` of page ids (-1 = unallocated), storage in
bf16 or ``torch.float8_e5m2``.  Page 0 is the engine's scratch page: writes
past the table width or into unallocated slots land there.  Unlike the
reference's immutable arrays, the pool is updated in place (it is the
largest buffer on the card; a copy per layer per tick would double its
traffic), so :meth:`update_layer` returns the layer views it wrote.
"""

from __future__ import annotations

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
                     head_dim: int, storage: str = "bf16") -> int:
    """Bytes ONE page occupies across all layers and both k/v pools (the
    unit of the engine's ``kv_pool_bytes`` budget)."""
    itemsize = torch.empty((), dtype=kv_storage_dtype(storage)).element_size()
    return n_layers * n_kv_heads * page_size * 2 * head_dim * itemsize


@dataclass
class PagedKVCache:
    """Block-table KV over a shared page pool (see the module docstring)."""

    k: torch.Tensor        # [L, P, Hkv, page, D]
    v: torch.Tensor        # [L, P, Hkv, page, D]
    tables: torch.Tensor   # [R, maxP] int32 page ids, -1 = unallocated
    storage: str = "bf16"

    @classmethod
    def init(cls, n_layers: int, n_pages: int, n_rows: int, max_pages: int,
             n_kv_heads: int, page_size: int, head_dim: int,
             storage: str = "bf16", device=None) -> "PagedKVCache":
        dtype = kv_storage_dtype(storage)
        shape = (n_layers, n_pages, n_kv_heads, page_size, head_dim)
        return cls(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
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
        # float8 pools scatter through a uint8 view of the same bytes: the
        # indexing kernels do not cover every float8 dtype on every device
        for layer, new in ((kl, new_k), (vl, new_v)):
            enc = self.encode(new)
            if enc.element_size() == 1:
                layer.view(torch.uint8)[pages, :, offs] = enc.view(torch.uint8)
            else:
                layer[pages, :, offs] = enc
        return kl, vl

    def gather_layer(self, kl: torch.Tensor) -> torch.Tensor:
        """Pool layer [P, H, page, D] -> head-major rows [R, H, maxP*page, D]."""
        return gather_rows(kl, self.tables)


def gather_rows(pool_layer: torch.Tensor, tables: torch.Tensor
                ) -> torch.Tensor:
    """Each row's pages in table order: pool layer [P, H, page, D] and
    tables [R, maxP] -> [R, H, maxP*page, D].  Unallocated (-1) entries
    read scratch page 0; slots past a row's length are garbage the
    caller masks."""
    r, maxp = tables.shape
    t = tables.long().clamp(0, pool_layer.shape[0] - 1)
    g = pool_layer[t].permute(0, 2, 1, 3, 4)        # [R, H, maxP, page, D]
    return g.reshape(r, g.shape[1], maxp * pool_layer.shape[2], g.shape[4])
